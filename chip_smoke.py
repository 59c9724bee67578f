#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

What it does, in order:

1. Card and build: prints the card's name and power limit (nvidia-smi),
   compiles the five CUDA sources with nvcc (``sm_90a``; one nvcc each, all
   started together) and prints the build time.
2. Main path (A) at the paper's scale — 100,000 Citeseer-like documents, the
   default field widths 512/512/1024 (D = 2048), K = 316 clusters
   (sqrt(n)), T = 3 clusterings. With every launch counter at 0 it builds
   the index through ``Retriever.build(method="auto")`` (``fpf_fused``: the
   rounds of each clustering's FPF run in one launch of the CUDA
   ``fpf_iter`` kernel), serves 64 more-like-this
   requests with Dirichlet field weights at probes=12, k=10 on the
   ``fused`` backend (the CUDA ``bucket_score_tiled`` kernel), the same
   requests through the exact tier, again on bf16 and int8 packs, and the
   exact tier on the int8 pack (kernel, then the fp32 rescore); then it
   reads the counters. The ``reference`` backend answers the same
   requests on the same index, on the card, outside the counted window.
   Quality path (B), counts at 0 again: ``calibrate_index`` fits the
   index's probe ladder on the fused backend (64 queries x 6 weight draws,
   every sweep level through ``bucket_score_tiled``), 64 requests are served
   at ``recall_target=0.9`` and at ``min_recall=0.9`` from probes=12, and
   the brute-force ground truth (top k+1 and bottom k) runs through the
   CUDA ``topk_score`` kernel (fp32: never its bf16 tensor-core core, a
   gate). Kernels-bench path (C), counts at 0 again:
   ``repro_torch.launch.kernels_bench.run`` drives every kernel at the
   reference bench's shapes, the only caller of ``bucket_score`` (v1) and
   ``embed_bag``.
   Repairs: the fused backend at D = 300 (20,000 documents) and at
   ``query_tile=32`` equals the reference / the default tile, and two
   builds on the card are bit-identical. The 100k build is replayed step
   by step with synchronised host timers (corpus to the card, sample, FPF
   per clustering, assignment, medoids, reassignment, bucket ids; then the
   bucket-major pack the first search makes) and must give the main
   path's index and pack bit for bit. Any D: the three kernels that stage
   queries (``bucket_score_tiled`` on all three packs, v1,
   ``topk_score``) at D = 8192 against their plain versions.
   Mutation path (D), counts at 0 again, on a copy of the built index:
   ``retriever.add`` of 1,000 documents (64 exact copies of the query
   documents among them), ``retriever.remove`` of 250 old and 250 new ones,
   then the 64 requests on ``fused`` (the first batch re-packs),
   ``reference`` and the exact tier, and a ``topk_score`` brute force
   masked by the tombstones; gated: every copy is hit #1 for ``like=`` its
   original with equal weights on all three, no removed id in any answer,
   fused == reference and exact == brute force as on the main path, one
   version bump per mutation, one re-pack, B grown only on overflow.
   Baselines path (E), counts at 0 again: CellDec (k-means, 10 iterations,
   4 regions) and PODS07 (random leaders) built on the same corpus and
   served the 64 requests at probes 12 through ``search_weighted``; gated
   on distinct ids, the excluded query never returned, scores equal to the
   exact rescore and ``n_scored`` in ``[K + 1, n]``; CR@10 / NAG of ours,
   CellDec and PODS07 against path B's ground truth and the build seconds
   are printed, the paper's ordering is not gated.
   Serving path (F), counts at 0 again, on a copy of the index without its
   pack: 1,024 requests of the load test's mix (3 of 4 at k = 10 / probes
   12, 1 of 4 at k = 20 / probes 8) submitted at once to a
   ``SearchServer(window_s=0.002, replicas=2)``, each replica on its own
   CUDA stream; gated: every request answered, the pack made once, ids,
   ``n_scored`` and scores equal to one-by-one sync search on rows free of
   near ties, and ``bucket_score_tiled`` launched exactly once per
   dispatch attempt the server's stats count plus once per sync check.
   Then the load test's loops (not counted): the sequential baseline, the
   closed loop (64 workers) on 1 and 2 replicas, the open loop at half the
   2-replica QPS; and the chaos suite (``hang_flap``, ``transient``, the
   load test's knobs and checks) on 4 replicas with at least 3 s of
   requests at the closed loop's rate.
   Sharded path (G), counts at 0 again, on copies of the 100k index
   without the fused pack: the shard packs' bytes reckoned on the host,
   then built (fp32, bf16, int8 at S = 4 on the one card; ``B_l``, bytes
   and seconds logged); the 64 requests through ``Retriever(backend=
   "sharded")``, the same queries plain, with ``rescore=40`` on the three
   packs, the exact tier on fp32 and int8, and ``distributed_brute_topk``
   over 4 shards; gated: exactly 4 ``bucket_score_tiled`` launches per
   sharded search and 4 ``topk_score`` launches for the brute force, fp32
   ids equal to fused on rows free of near ties with scores within
   ``SHARD_ATOL`` (bit-equality reported) and ``n_scored`` equal, the
   exact tiers and the brute force equal to path B's ground truth, bf16 /
   int8 ``n_scored`` equal to fp32 with overlap >= 0.9 and their rescore
   tails equal to fused's on the same pack. Then (not counted) each
   shard's ``bucket_score_tiled`` call at the shard-local shape against
   its plain version on the three packs; shards on distinct cards where
   there are several (a line says when there is one); a 256-request burst
   of the load test's mix through ``SearchServer`` on the sharded backend
   against one-by-one sync search; path D's 1,000 adds and 500 removes
   under a held engine (one repack, equal to the reference backend); the
   timing of fused and of the sharded engine at S = 1, 2, 4, 8 (CUDA
   events, median of 10, each pack built and dropped in turn, the shards'
   scoring and merge launches and the cross-shard merge split out, the
   packed bytes per query); and ``throughput.run`` at quick scale with its
   byte-ratio gate. A ``sharded`` JSON line carries its numbers.
   Recsys path (H), after the gates of A-G and with path A's pack dropped:
   the four recsys configurations at ``make_config()`` widths (DLRM's five
   Criteo-TB tables above 8,000,000 rows capped there, the one cut: 96 GB
   of tables do not fit one card), random weights from seeds. Counts at 0,
   then ``recsys_serve_step`` at serve_p99's batch of 512 for DLRM one-hot
   (the gather) and multi-hot (8 ids a field: the CUDA ``embed_bag``, one
   launch per table), AutoInt, BST and MIND, and MIND's retrieval_cand
   (one user, top-100 over 1,000,448 items) through
   ``recsys_retrieval_step`` with its ``topk_score`` yardstick; gated:
   exactly 26 ``embed_bag`` launches and 1 ``topk_score``, finite outputs,
   the top-100 equal to ``topk_score`` at every position clear of near
   ties. Then (not counted) the multi-hot logits against the same forward
   with the plain ``embed_bag_ref`` (``RECSYS_ATOL``), each table's call
   against its plain version, the 26 calls against 26 ``F.embedding_bag``
   in turns and as device time, and each forward's time. Counts at 0
   again: ``repro_torch.examples.recsys_retrieval.run`` at the full MIND
   config (8 users, interests tiled to (1,000,448, 256), a ``fpf_fused``
   index with K = 1,000, T = 3, calibrated, ``recall_target=0.9``); gated:
   exactly 3 ``fpf_iter``, one ``bucket_score_tiled`` per sweep level plus
   the exact tier and the request batch, 1 ``topk_score``, and achieved
   recall >= predicted - 0.05. Then (not counted) ``bucket_score_tiled``
   against its plain version on the retriever's own kernel inputs for the
   8 requests at every budget the path ran (sweep levels, plan, exact
   tier), and ``fpf_iter`` on the build's first FPF sample (three rounds,
   and each round of a whole run against a plain round); gated as on
   path A. A
   ``recsys`` JSON line carries its numbers.
3. Kernels against their plain PyTorch versions on the paths' own inputs
   (their launches are not counted).
4. Timing with CUDA events, next to each kernel's bound and, where one
   PyTorch call computes the same function, that call's time; the fused
   batch split into navigation, schedule, scoring launch, merge launch and
   decomposition; ``bucket_score`` (v1) on the three packs at the main
   path's 64 x 12 flat probes, each split into inversion, scoring launch
   and merge launch; ``embed_bag`` and ``F.embedding_bag`` at DLRM's
   multi-hot shape (path H) as device time (a CUDA graph) and per call.
5. The gates, path H. Then paths A-H's tensors are freed (they run in
   ``paths_a_to_h``) and the training path (I) runs: each recsys
   configuration at ``make_config()`` widths trained by
   ``recsys_train_step`` with ``adamw(1e-3)`` at the reference's
   ``train_batch`` of 65,536 (DLRM's tables above 2,000,000 rows capped
   there, the one cut: parameters, gradients and moments of 96 GB of
   tables do not fit; listed as ``reduced``), DLRM both one-hot and
   multi-hot (8 ids a field: the CUDA ``embed_bag`` forward, its plain
   backward). Each run's bytes are reckoned on the host first and must fit
   the card's free memory. Counts at 0 per run, one warm-up step through
   ``recsys_train_step``, then 4 steps timed with CUDA events split into
   forward + backward and the optimizer; gated: exactly 26 ``embed_bag``
   launches per multi-hot step and none elsewhere, finite losses and
   gradients, one multi-hot step's gradients with the CUDA forward equal
   to the same step with ``embed_bag_ref`` in it (``I_GRAD_RTOL``), and
   the reference's BST learning recipe (60 steps of 256, ``adamw(1e-2)``).
   Not gated: ``embed_bag`` at the training shape against
   ``F.embedding_bag`` (forward in turns and as device time, the plain
   backward against the library's), each beside its bound; the
   optimizer's byte bound; the model-flop rate; peak memory. A ``train``
   JSON line carries them.
6. The LM path (J), after path I with its tensors freed, every kernel
   count at 0 (the LM family reaches none of the five kernels, so every
   count must stay 0): qwen3-8b and qwen2-moe-a2.7b at ``make_config()``
   widths and depths in bf16, one after the other, each freed before the
   next. Each run's bytes (weights, the batch-8 cache at max_seq_len
   4,096, one layer's largest transient, the check forward's logits) are
   reckoned on the host (``lm_bytes``) and must fit the card's free
   memory. Weights are drawn on the card from a seed, chunk by chunk in
   bf16; 8 prompts of 2,048 tokens (``lm_batch`` step 0) are prefilled
   and 32 greedy ``decode_step``s follow, a warm-up round then 3 timed
   ones (CUDA events, median): prefill tokens/s and model-flop rate
   against the bf16 peak, decode ms a step against its byte bound (the
   weights but the embedding table, and the whole cache). Gated: finite
   logits, cache length 2,048 + 32; the first decode step against
   ``forward`` on the 2,049-token rows (``j_decode_tol``: max |delta|
   and RMS relative to the logits', top-1 equal on rows clear of near
   ties; qwen2-moe at ``capacity_factor`` 8 on its first layer, its
   full-depth numbers reported, see ``J_CHECK_LAYERS``); block 0 at 1 x
   512 tokens on the card against the port's CPU path on the same inputs
   and weights (``J_BLOCK_TOL`` per token, at most ``J_BLOCK_OUTLIERS``
   tokens past it, ``J_BLOCK_RMS``). Then 20 training steps of
   ``examples/train_lm.py``'s ~100M qwen3-style config (fp32) through
   ``loss_fn``, the backward through the per-block checkpoint and
   ``adamw(3e-4)`` at batch 8 x 256; gated: the loss falls by
   ``J_LEARN_MARGIN``. An ``lm`` JSON line carries the numbers, the
   memory reckoned against the peak allocated and the path's seconds.
7. The training-driver path (K), after path J with its tensors freed,
   every kernel count at 0 (the driver reaches none of the five kernels,
   so every count must stay 0). ``launch.train.train_lm`` on qwen3-8b at
   ``make_config()`` widths in bf16, ``adamw(3e-4)``, batch 8 x 512 from
   ``lm_batch``: K_WARMUP step, then K_STEPS timed with CUDA events split
   into forward + backward and the optimizer (``StepEvents`` wraps the
   driver's two calls); tokens/s, the model-flop rate (6 x active
   parameters x tokens) against the bf16 peak, the optimizer against its
   byte bound (K_ADAMW_BYTES a parameter), peak memory against the
   reckoning. Depth is the one cut (``reduced``): the largest whole number
   of blocks whose reckoning (``lm_train_bytes``) fits K_MEM_SHARE of the
   card's free memory. No checkpoint is written at this size (10 B a
   parameter: 27.9 GB of disk at 8 blocks, 43.3 GB at 16). Gated: finite
   losses. Then the checkpoint phase, ``examples/train_lm.py``'s ~100M
   config in fp32 and again in bf16 through ``train_lm``: 20 steps
   uninterrupted against 10 steps with a checkpoint directory and a resume
   to 20 (``CheckpointLog`` keeps a host copy of what each save wrote and
   each restore returned); gated: every restored leaf bit-equal to the
   saved one, the bf16 run's parameters restored as bf16, the resumed
   losses equal to the uninterrupted run's (K_RESUME_ATOL). Then the
   preemption phase: ``python -m repro_torch.launch.train --arch qwen3-8b
   --smoke`` in a subprocess on the card, SIGTERM after its first logged
   step; gated: exit 0, one checkpoint at the step it names, and an
   in-process resume that runs only the remaining steps. A
   ``train_driver`` JSON line carries the numbers and each phase's
   seconds.
8. The GNN path (L), every kernel count at 0 again (it must stay 0): the
   reference's four ``gcn-cora`` shapes (``gcn_shapes``), each trained
   L_STEPS steps with ``adamw(1e-2)`` from a seed, CUDA events a step:
   Cora full batch (``cora_like(2708, 4.0, 1433, 7)``, ``make_config()``);
   ogbn-products full batch (``power_law_graph(2_449_029, 61_859_140, 100,
   47)``, its edge count after ``_symmetrize``'s dedup printed, its bytes
   reckoned by ``gnn_full_bytes`` and checked against the free memory
   first, its step against the least-traffic bound); the sampled
   minibatch at its cell's d 602 / 41 classes, 1,024 seeds, fanouts (15,
   10) through ``to_csr`` + ``sample_khop`` on the host, the features on
   the card, each step split into host sampling and device time (the one
   cut, listed as ``reduced``: it samples the products graph, as the
   Reddit-shape graph took L_REDDIT_HOST_S on the host); the molecule
   batch (128 x 30, ``graph_readout_loss``). Gated: finite losses, the
   loss falls over the 10 steps on Cora and on products, one Cora step's
   logits, loss and gradients on the card against the port's CPU step on
   the same weights and inputs (L_CPU_RTOL). A ``gnn`` JSON line carries
   each shape's ms a step, peak memory and losses.
9. The paper-retrieval path (M), after path L with its tensors freed.
   M1: ``launch.dryrun.run_cell`` of the arch's four cells (serve_online,
   serve_online_prefilter, serve_brute, build_assign) on both production
   meshes, the fake process group at 256 and 512 ranks with the HW_H100
   constants: each cell's per-chip compute, memory and collective terms,
   bottleneck and argument bytes (predictions; a ``dryrun`` JSON line).
   M2, every count at 0: rank 0's program of each cell on the card at the
   single-pod mesh's per-chip shape (``M_*``: 390,624 bf16 rows of D =
   4096 drawn from M_SEED, 256 weighted queries excluding their own
   documents, K = 3 x 10,000 leaders from the ``fpf_iter`` kernel on a
   sqrt(K n) sample, ``build_assign``'s step per clustering, local buckets
   cut to bucket_pad 64 with the dropped members printed), then
   ``serve_online``, ``serve_online_prefilter`` and ``serve_brute`` (the
   ``topk_score`` kernel on bf16 with ``round_bf16``) once each. Gated:
   ``topk_score`` launched, once through its tensor-core core
   (``tc_launches``), and ``bucket_score_tiled`` not (the reference
   cell is the gather oracle); no excluded, sentinel or repeated id; every
   returned score within one bf16 ulp of its exact bf16 rescore;
   ``serve_brute`` against its plain version (one ulp at each position,
   ids equal on rows without near ties and on rows whose scores are
   equal); ``topk_score``'s tensor-core core faster than its CUDA-core
   core and than ``torch.topk((q @ docs.T).float())``, timed in turns
   (tensor cores, CUDA cores forced with ``core="fma"``, tensor cores).
   Not gated: recall@10 of the pruned steps against the brute force; each
   step's time (CUDA events, median of M_REPS) beside M1's single-pod
   roofline; ``topk_score`` beside its plain version, its bound and the
   composite in fp32; the tensor-core build's ptxas line. A ``paper`` JSON
   line; a line gives paths J-M's seconds; then the ``kernels`` JSON line
   (all five kernels; launches from paths A, B and C, ``embed_bag``'s from
   path H with its times at DLRM's multi-hot serving shape, path G's in the
   ``sharded`` line, ``topk_score``'s from path M at its shape), the card
   line, and as the last line ``{"ok": true, "device": {...}}``.

Any failed gate exits non-zero without the last line. Without a CUDA card,
or outside a checkout (no ``src/repro_torch`` beside this file), it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_DOCS, K_CLUSTERS, T, N_QUERIES, PROBES, K = 100_000, 316, 3, 64, 12, 10
RAGGED_NQ = 37
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                # fp32 outside the tensor cores
SMEM_BYTES_PER_S = 33.4e12        # shared memory: 128 B a clock on each of
                                  # 132 SMs at 1.98 GHz
# the TS2 build's FPF sample (sqrt(K n) of 100,000 documents, K = 1,000)
# and its index's hashed field widths
TS2_FPF_M, TS2_FPF_K, TS2_FIELD_DIMS = 10_000, 1_000, (1024, 1024, 2048)
# Tolerances, each with its reason:
# fpf_iter: one 2048-term fp32 dot per row, summed in another order than
#   the plain torch.mv -> differences of a few ulps of values <= 1.
FPF_ATOL = 1e-5
# bucket_score_tiled fp32: the same 2048-term sums in another order.
BST_F32_ATOL = 1e-4
# bf16 / int8: both sides compute exact products of the same bf16-rounded
#   query; the residue is fp32 summation order, scaled by |scale| <= ~0.01
#   for int8, so 2e-3 is loose; ids may swap where scores tie within it.
BST_Q_ATOL, BST_Q_OVERLAP = 2e-3, 0.99
# Exact-tier and fused-vs-reference scores: fp32 order differences.
SCORE_ATOL = 1e-4
NEAR_TIE = 1e-5                   # id checks skip rows with a gap below this
OVERLAP_FLOORS = {"bfloat16": 0.97, "int8": 0.95}   # tests/test_quality.py
# topk_score vs its plain version: 2048-term fp32 sums in another order.
TOPK_ATOL = 1e-5
# bucket_score (v1): fp32 query x fp32 or widened bf16 / int8 values on
#   both sides, so only the summation order differs. int8 takes no scale
#   (v1 has no scales operand): its dots reach ~10^3, so its tolerance and
#   its near-tie gap are taken relative to its largest |score|.
V1_ATOL = 1e-4
# embed_bag fp32: 16 weighted fp32 terms per value in another order.
EMBED_ATOL = 1e-5
# Recall targets / floors served on the quality path: 0.9, and 0.8, which
#   on this index plans a rung below the full sweep (the default grid's fit
#   tops out under 0.9 there, so 0.9 plans T*K).
RECALL_TARGETS = (0.9, 0.8)
RECALL_SLACK = 0.05               # serve.py's held-out rule
REPAIR_DOCS, REPAIR_DIMS = 20_000, (100, 100, 100)
# The D = 8192 phase: past the 6912 columns at which the kernels that stage
# whole query rows in shared memory used to raise.
WIDE_D, WIDE_DOCS = 8192, 4000
# bucket_score_tiled's time per 64-query batch in its first CUDA design (one
# CTA per query tile), per pack, on an H100 80GB HBM3 at 700 W (PERF.md)
BST_ONE_CTA_MS = {"float32": 51.66, "bfloat16": 39.03, "int8": 31.98}
BENCH_V, BENCH_E, BENCH_B, BENCH_L = 100_000, 128, 256, 16
# The mutation path: documents added (the 64 query documents' copies among
# them) and removed (half old, half new), and the seed of the added corpus.
MUT_ADD, MUT_REMOVE, MUT_SEED = 1000, 500, 5
# CellDec / PODS07 scores against docs[ids] . qw: one fp32 dot of 2048 terms
# per hit, the same formula in another batch shape.
BASE_ATOL = 1e-5
CUDA_SOURCES = ("bucket_score_tiled", "bucket_score", "topk_score",
                "embed_bag", "fpf_iter")
# The serving path (F): requests of the load test's mix in the parity burst
# and the throughput loops, its micro-batch window, the chaos profiles run
# (the load test's acceptance profile and retries), and the least length of
# each chaos run at the 2-replica closed loop's rate: the breaker's 0.5 s
# cooldown must elapse several times inside it for a trip AND a recovery.
F_REQUESTS, F_WINDOW_S = 1024, 0.002
F_CHAOS_PROFILES = ("hang_flap", "transient")
F_CHAOS_SECONDS = 3.0
# The sharded path (G): shards on the one card for its gates, the shard
# counts timed, the serving burst, the rescore depth of its rescore checks
# and the bf16 / int8 overlap floor with the fp32 sharded answers.
G_SHARDS, G_TIMING_SHARDS, G_REQUESTS, G_RESCORE = 4, (1, 2, 4, 8), 256, 40
G_OVERLAP = 0.9
# Sharded fp32 scores against fused: one CUDA kernel sums each (query, row)
# dot in the same order whatever the bucket block, so they should be
# bit-equal; 1e-4 allows fp32 order differences, as SCORE_ATOL does.
SHARD_ATOL = 1e-4
# The recsys path (H): the four recsys configurations at make_config()
# widths. DLRM's 26 Criteo-TB tables hold ~188M rows x 128 x 4 B = 96 GB in
# fp32, more than one 80 GB card (the reference row-shards them), so the
# five tables above DLRM_ROW_CAP rows are capped there (a 512 multiple);
# nothing else is cut. serve_p99's batch, the multi-hot bag length that
# takes DLRM's embed_bag branch, retrieval_cand's top-k and the pruned
# index's K (sqrt(n)).
DLRM_ROW_CAP = 8_000_000
H_BATCH, H_MULTI_HOT, H_TOPK, H_K_CLUSTERS = 512, 8, 100, 1_000
# DLRM logits with the CUDA embed_bag against the same forward with the
# plain embed_bag_ref on the card: each bag is 8 fp32 rows (values ~0.1)
# summed in another order, a few ulps, carried through the 351 pairwise
# dots and the top MLP to logits of magnitude ~1.
RECSYS_ATOL = 2e-5
# embed_bag against embed_bag_ref per table at that shape: 8 fp32 terms.
H_EMBED_ATOL = 1e-6
# recsys_retrieval_step (4 interest dots of 64 terms, weighted) against
# topk_score on the reduced query (one 64-term dot): summation order only.
RETRIEVAL_ATOL = 1e-5
# The pruned MIND index against the plain versions holds bucket_score_tiled
# to BST_F32_ATOL and fpf_iter to FPF_ATOL, as path A: 256-term fp32 sums
# there against 2048 here, so the same order differences are smaller still.


# The training path (I): recsys_train_step with adamw(1e-3) (the body of the
# reference's recsys_train_cell) at train_batch, the batch of every recsys
# config's train cells. Parameters, dense gradients and two fp32 AdamW
# moments are 4 copies of the model: DLRM's 96 GB of tables would need 385
# GB, so its tables above I_ROW_CAP rows are capped there (13,117,184 of
# 187,775,488 rows, 26.9 GB of state); nothing else is cut. One warm-up
# step, then I_STEPS timed ones; the reference's BST learning recipe.
I_BATCH, I_ROW_CAP, I_STEPS, I_MULTI_HOT = 65_536, 2_000_000, 4, 8
I_LEARN = dict(steps=60, batch=256, lr=1e-2, margin=0.02)
# Gradients of one multi-hot step with the CUDA embed_bag in the forward
# against the same step with embed_bag_ref in it, relative to each
# tensor's largest value: the bags (8 fp32 terms) differ by a few ulps, and
# a table's gradient sums up to ~60,000 hits on a row of the smallest
# tables in index_add_'s atomic order on one side and autograd's sorted
# index_put_ on the other, sqrt(n) * 2**-24 ~ 1.5e-5 of the terms' scale;
# 1e-3 holds that with margin, while a missed or doubled slot moves a row
# by its whole value.
I_GRAD_RTOL = 1e-3
# The optimizer's least bytes per parameter: read p, g, m, v, write p, m,
# v, and the clip's read of g.
ADAMW_BYTES_PER_PARAM = 32

# The LM path (J): the two LM configurations one 80 GB card holds in bf16
# with a batch-8 cache of max_seq_len 4,096, served at make_config() widths
# and depths: 8 prompts of 2,048 tokens (lm_batch step 0), prefill, then 32
# greedy decode steps; a warm-up round, then J_REPS timed ones (median).
J_ARCHS = ("qwen3-8b", "qwen2-moe-a2.7b")
J_BATCH, J_PROMPT, J_STEPS, J_REPS = 8, 2048, 32, 3
J_BLOCK_TOKENS = 512              # the block held against the CPU: 1 x 512
BF16_FLOPS = 989e12               # dense bf16 tensor-core peak, H100 SXM
# The MoE check runs at this capacity factor, as the reference's
# test_lm_smoke_prefill_decode: no capacity drops (the path reports any).
J_CHECK_CF = 8.0
# First decode step against forward on the 2,049-token sequences, both in
# bf16 on the card. The two compute the same function with different bf16
# rounding points (decode_attention against blockwise_attention, 2 kv
# chunks against 3 for the 2,049 tokens), each rounding <= 2^-9 of its
# value. Per layer the residual update picks up a relative error of about
# 2^-8; over L layers these add as a random walk, sqrt(L) * 2^-8 of the
# final hidden state (0.023 at L = 36). The final rmsnorm makes that state
# unit-RMS and unembed (N(0, 1/d)) makes logits ~ N(0, 1), so a logit
# moves by ~0.023 x N(0, 1), whose maximum over V = 151,936 entries is ~5
# x that (sqrt(2 ln 2V)). The gates take 4x these: max |delta| <=
# 4 * 5 * sqrt(L) * 2^-8 (0.47 at L = 36, 0.38 at L = 24) and RMS(delta) /
# RMS(logits) <= 4 * sqrt(L) * 2^-8. Top-1 must agree on every row whose
# top-2 gap exceeds twice that row's max |delta| (clear of near ties).
#   The random walk holds while the function is smooth at the bf16 scale.
# qwen3-8b's qk-norm keeps attention scores ~N(0, 1). qwen2-moe has no
# qk-norm, and under the reference's fan-in rule (wq, wk ~ N(0,
# 1/n_heads)) its scores have a std of ~128: each softmax is an argmax
# that one bf16 ulp can tip (as can a top-4 router near tie), and a
# tipped row changes by O(1) and feeds every layer above. The reference
# shows it too: decode against forward in bf16 at qwen2-moe's widths
# (16 experts, 6 layers, 2 x 256 tokens, on the CPU) is 0.48 apart in
# RMS in JAX and 0.59 in the port, 0.0009 in the port in fp32; the port
# at full width (2 x 512 tokens) gives 0.0019 / 0.012 / 0.26 at 1 / 2 / 4
# layers. So qwen2-moe's gated check runs on the served weights' first
# J_CHECK_LAYERS layers (full width, its 64-expert MoE, the full vocab),
# and its full-depth numbers are reported, not gated.
J_CHECK_LAYERS = {"qwen2-moe-a2.7b": 1}


def j_decode_tol(n_layers: int) -> tuple[float, float]:
    walk = float(np.sqrt(n_layers)) * 2.0 ** -8
    return 4 * 5.0 * walk, 4 * walk


# One full-width block, the card's bf16 output against the port's CPU
# output on the same inputs and weights. Both round to bf16 at the same
# places; the fp32 sums run in another order, so an intermediate may land
# one bf16 ulp (2^-8 relative) apart and carry to the output: per token,
# max |delta| <= 2^-5 of the output's largest |value| (8 ulps at the top
# of its range), and RMS(delta) <= 2^-7 of the output's RMS over those
# tokens. A token whose hard attention or top-k routing tips on such an
# ulp (see above; ~0.4 of 512 tokens expected for qwen2-moe's block 0)
# differs by O(its value): at most J_BLOCK_OUTLIERS of the tokens may
# exceed the tolerance, and tokens whose experts differ are counted.
J_BLOCK_TOL, J_BLOCK_RMS, J_BLOCK_OUTLIERS = 2.0 ** -5, 2.0 ** -7, 0.01
# Training: examples/train_lm.py's ~100M qwen3-style config (its dtype is
# the default fp32), adamw(3e-4), batch 8 x 256 from lm_batch; the loss
# must fall: the mean of the last 5 losses below the mean of the first 5
# by J_LEARN_MARGIN.
J_TRAIN = dict(steps=20, batch=8, seq_len=256, lr=3e-4)
J_LEARN_MARGIN = 0.1

# The training-driver path (K). train_lm on qwen3-8b at make_config()
# widths in bf16 (d 4,096, 32 / 8 heads, d_ff 12,288, vocab 151,936),
# adamw(3e-4), batch 8 x 512 from lm_batch: K_WARMUP step(s), then K_STEPS
# timed ones, no checkpoint (at 8 blocks one would be 27.9 GB of disk: 10
# B a parameter). Depth is the one cut: the 36 blocks need ~98 GB of bf16
# parameters and gradients and fp32 moments, so the path reckons a run's
# bytes on the host (lm_train_bytes) and takes the largest whole number of
# blocks whose reckoning fits K_MEM_SHARE of the card's free memory (the
# rest is the caching allocator's slack and fragmentation).
K_ARCH = "qwen3-8b"
K_BATCH, K_SEQ, K_WARMUP, K_STEPS, K_LR = 8, 512, 1, 5, 3e-4
K_MEM_SHARE = 0.85
# The optimizer's least bytes per bf16 parameter: read p (2), g (2), m (4)
# and v (4), write p, m and v (2 + 4 + 4).
K_ADAMW_BYTES = 22
# The checkpoint phase: examples/train_lm.py's ~100M config in fp32 and in
# bf16 through train_lm: K_RESUME["steps"] steps uninterrupted against a
# run to K_RESUME["at"] with ckpt_dir set, then a resume to "steps". The
# resumed run restores every tensor bit for bit and replays the same
# batches (lm_batch is stateless in (seed, step)), so each of its steps is
# the uninterrupted run's computation on the same inputs, on the same card
# and with the same kernels (cuBLAS picks its algorithm by shape; the
# dense model's only scatter, the loss's gather backward, writes one
# element a row): its losses must equal the uninterrupted run's bit for
# bit (K_RESUME_ATOL = 0).
K_RESUME = dict(steps=20, at=10, batch=8, seq_len=256, lr=3e-4, ckpt_every=10)
K_RESUME_ATOL = 0.0
# The preemption phase: `python -m repro_torch.launch.train --arch
# qwen3-8b --smoke` in a subprocess, SIGTERM after its first logged step
# (on an H100 the signal lands during step 1, a step taking ~0.28 s: 20
# steps leave it ~5 s), and the subprocess gets K_PREEMPT_TIMEOUT_S to
# start and to finish.
K_PREEMPT_STEPS, K_PREEMPT_TIMEOUT_S = 20, 300

# The GNN path (L): the reference's four gcn-cora shapes
# (src/repro/configs/gcn_cora.py cells(), :36-64), each trained L_STEPS
# steps with adamw(1e-2) (the body of gnn_full_cell / gnn_minibatch_cell /
# gnn_molecule_cell), random weights from seeds. Nothing is cut: Cora full
# batch at make_config(); ogbn-products full batch at its published 2.45M
# nodes / 61.86M edges (before _symmetrize's dedup) / d 100 / 47 classes;
# the sampled minibatch at its cell's d 602 / 41 classes, 1,024 seeds,
# fanouts (15, 10); 128 molecule graphs of 30 nodes. One cut, listed as
# `reduced`: the minibatch samples from the products graph (features of d
# 602 and labels of 41 classes drawn on the card from a seed, by
# power_law_graph's recipe) instead of a Reddit-shape graph (232,965
# nodes, 114.6M edges), whose generation and CSR took L_REDDIT_HOST_S on
# the H100 machine's host, over the 40 s the smoke allows it.
L_STEPS, L_LR = 10, 1e-2
L_CORA = dict(n_nodes=2708, avg_degree=4.0, d_feat=1433, n_classes=7)
L_PRODUCTS = dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                  n_classes=47)
L_REDDIT = dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                n_classes=41)
L_REDDIT_HOST_S = 83.3
L_SEEDS, L_FANOUTS = 1024, (15, 10)
L_MOLECULE = dict(batch=128, nodes_per_graph=30, edges_per_graph=64,
                  d_feat=16, n_classes=2)
# One Cora step on the card against the port's CPU step on the same
# weights and inputs: each aggregated value sums deg + 1 fp32 terms, which
# index_add_ adds with atomics in no fixed order on the card, and the
# products sum 1,433 / 16 terms in cuBLAS's order against the CPU BLAS's:
# a few ulps (2^-24) of the sums' magnitudes, carried through two layers,
# the softmax and the backward. 1e-4 of each tensor's largest |value|
# holds that with margin; a dropped, doubled or misrouted edge moves a
# row by a whole term.
L_CPU_RTOL = 1e-4
# Path M (paper-retrieval): M1 runs the dry-run of the arch's four cells on
# both production meshes (fake process group, HW_H100 constants); M2 runs
# rank 0's program of each cell on the card at the single-pod mesh's
# per-chip shape: 99,999,744 / 256 = 390,624 rows of D = 4096 in bf16
# (the one cut, listed as `reduced`: n_docs is the per-chip share), K = 3
# x 10,000 leaders from the fpf_iter kernel on a sqrt(K n) sample of the
# shard, buckets cut to bucket_pad 64, 256 weighted queries, k = 10. The
# shard is clustered synthetic data from M_SEED: M_TOPICS topic vectors,
# each row a topic plus M_NOISE x its own N(0, 1) draw, unit-norm per field
# (a same-topic pair's cosine is about 1 / (1 + M_NOISE^2)).
M_SEED = 23
M_QUERIES = 256
M_SHARDS = 256                    # the single pod's chips (rank 0's share)
M_TOPICS = 4096
M_NOISE = 1.0
M_CHUNK = 65_536                  # rows drawn (and projected) at a time
M_REPS = 10
M_PROJ = 256                      # the prefilter cell's JL width


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fpf_held_compacted(x) -> int:
    """The rows of ``x`` that ``fpf_iter``'s CTAs hold in shared memory in
    compacted form: the kernel's own count, from one round."""
    import torch

    from repro_torch.kernels.fpf_iter.ops import _launch

    centers = torch.zeros((2,), dtype=torch.int32, device=x.device)
    vals = torch.empty((2,), device=x.device)
    ms = torch.empty((x.shape[0],), device=x.device)
    return int(_launch(x, None, ms, centers, vals, 2))


def fpf_round_bounds_ms(x, held: int, n_rounds: int) -> tuple[float, float]:
    """Two bounds of one ``fpf_iter`` round over the rows ``x``, in ms: the
    dense-equivalent one (2 m D flops at the fp32 peak, or the sample read
    once over the run) and the held form's: the rows the CTAs hold
    compacted read from shared memory (lane counts, table entry, column,
    value and one center word a nonzero, at the sample's mean nonzeros),
    the other rows from device memory, and the sample read once over the
    run. The grid barrier, ~1.6 us a round on the H100, is in neither."""
    import torch

    m, d = x.shape
    run_bytes = (m * d + m) * 4
    dense_ms = max(run_bytes / HBM_BYTES_PER_S / n_rounds,
                   2 * m * d / FP32_FLOPS) * 1e3
    nnz = float((x != 0).sum(1, dtype=torch.int64).double().mean())
    held_ms = (held * (10 * nnz + 68) / SMEM_BYTES_PER_S
               + (m - held) * d * 4 / HBM_BYTES_PER_S
               + run_bytes / HBM_BYTES_PER_S / n_rounds) * 1e3
    return dense_ms, held_ms


def graph_ms(fn, reps: int = 200) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, events around a replay (no host work between the launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rows_without_near_ties(scores: np.ndarray) -> np.ndarray:
    """Rows whose top-(k+1) finite scores are all more than NEAR_TIE apart
    (there, ids are fixed by the scores, whatever the summation order)."""
    s = np.where(np.isfinite(scores), scores, -1e30)
    return np.all(-np.diff(s, axis=1) > NEAR_TIE, axis=1)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([len(set(x) & set(y) - {-1}) / max(1, len(set(y) - {-1}))
                          for x, y in zip(a.tolist(), b.tolist())]))


def events_ms(fn, reps: int = 10) -> float:
    """Median time of ``fn()`` over ``reps`` calls, CUDA events around
    each (host launch gaps included), after one warm-up call."""
    import torch

    out = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(out[1:]))


def ids_agree(got_ids, want_ids, want_scores, k) -> tuple[bool, int]:
    """Top-``k`` ids of one row against a reference's top-``k + 1``: equal
    at every position whose neighbouring scores are more than NEAR_TIE
    apart, and equal as sets when the k-th and (k+1)-th scores are. Returns
    (agree, positions checked)."""
    s = np.asarray(want_scores, np.float64)
    gaps = -np.diff(s)                                    # (k,)
    clear = gaps[:k] > NEAR_TIE                           # to the next
    clear[1:] &= gaps[:k - 1] > NEAR_TIE                  # to the previous
    ok = np.array_equal(np.asarray(got_ids)[clear],
                        np.asarray(want_ids)[:k][clear])
    if gaps[k - 1] > NEAR_TIE:
        ok &= set(np.asarray(got_ids).tolist()) == set(
            np.asarray(want_ids)[:k].tolist())
    return bool(ok), int(clear.sum())


def pruned_kernel_checks(retriever, requests, grid, probes, uncounted,
                         failures) -> dict:
    """Path H's pruned index against the plain versions, on its own inputs
    (not counted): ``bucket_score_tiled`` on the retriever's kernel inputs
    for the requests at every probe budget the path ran (the sweep's
    levels, the planned budget, the exact tier), and ``fpf_iter`` on the
    build's first FPF sample (its draws replayed from the build's seed):
    three chained rounds, then every round of a whole run against a plain
    round from the run's previous center. Appends gate failures; returns
    the numbers."""
    import torch

    from repro_torch.core import get_engine
    from repro_torch.core.cluster import fpf_sample_size
    from repro_torch.kernels import (bucket_score_tiled,
                                     bucket_score_tiled_ref,
                                     fpf_centers_fused, fpf_iter,
                                     fpf_iter_ref)

    index = retriever.index
    eng = get_engine(index, retriever.backend, **retriever.engine_opts)
    qw = retriever._resolve_qw(requests)
    k = requests[0].k
    total = int(index.counts.numel())
    bst = {"probes": [], "max_abs_err": 0.0, "rows_checked": 0, "rows": 0}
    for p in sorted({int(g) for g in grid} | {int(probes), total}):
        _, args, kw = eng.kernel_inputs(qw, probes=p, k=k)
        s_k, i_k = uncounted("bucket_score_tiled",
                             lambda: bucket_score_tiled(*args, **kw))
        s_p, i_p = bucket_score_tiled_ref(*args, **kw)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        fin = np.isfinite(s_p)
        ok = rows_without_near_ties(s_p)
        err = (float(np.abs(s_k[fin] - s_p[fin]).max()) if fin.any()
               else 0.0)
        bst["probes"].append(p)
        bst["max_abs_err"] = max(bst["max_abs_err"], err)
        bst["rows_checked"] += int(ok.sum())
        bst["rows"] += len(ok)
        if (not np.array_equal(fin, np.isfinite(s_k)) or err > BST_F32_ATOL
                or not np.array_equal(i_k[ok], i_p[ok])):
            failures.append(
                f"bucket_score_tiled vs plain at probes={p} (D = "
                f"{qw.shape[1]}, B = {index.buckets.shape[-1]}): err {err}, "
                f"ids differ on {int(np.sum(np.any(i_k != i_p, 1)[ok]))} of "
                f"{int(ok.sum())} rows free of near ties")

    # the first clustering's draws, as ClusterPruneIndex.build makes them
    n, kc = int(index.docs.shape[0]), int(index.counts.shape[1])
    g = torch.Generator().manual_seed(0)
    m = max(min(fpf_sample_size(kc, n), n), kc)
    sample = torch.randperm(n, generator=g)[:m]
    first = int(torch.randint(0, m, (1,), generator=g))
    x = index.docs[sample.to(index.docs.device)].contiguous()
    dev = x.device
    fpf = {"m": m, "d": int(x.shape[1]), "max_abs_err": 0.0}
    ms_k = torch.full((m,), float("-inf"), device=dev)
    ms_p = ms_k.clone()
    cur_k = cur_p = torch.tensor(first, dtype=torch.int32, device=dev)
    for r in range(3):                          # three chained rounds
        ms_k, cur_k, _ = uncounted("fpf_iter",
                                   lambda: fpf_iter(x, cur_k, ms_k))
        ms_p, cur_p, _ = fpf_iter_ref(x, cur_p, ms_p)
        err = float((ms_k - ms_p).abs().max())
        fpf["max_abs_err"] = max(fpf["max_abs_err"], err)
        two = torch.topk(ms_p, 2, largest=False).values.cpu().numpy()
        if err > FPF_ATOL or (int(cur_k) != int(cur_p)
                              and two[1] - two[0] > FPF_ATOL):
            failures.append(f"fpf_iter vs plain on the build's sample "
                            f"(m = {m}) round {r}: maxsim err {err}, center "
                            f"{int(cur_k)} vs {int(cur_p)}")
        cur_p = cur_k                           # keep the two chains together
    # a whole run: each round's plain step from the run's previous center;
    # the run's center must be the plain argmin, or within FPF_ATOL of it
    run_k = uncounted("fpf_iter", lambda: fpf_centers_fused(x, kc, first))
    ms_p = torch.full((m,), float("-inf"), device=dev)
    fpf["rounds_equal"] = fpf["rounds_near_tie"] = 0
    for i in range(1, kc):
        ms_p, cur_p, _ = fpf_iter_ref(x, run_k[i - 1], ms_p)
        got, want = int(run_k[i]), int(cur_p)
        gap = float(ms_p[got] - ms_p[want]) if got != want else 0.0
        if gap > FPF_ATOL:
            failures.append(f"fpf_centers_fused on the build's sample: round "
                            f"{i} center {got} is {gap} above the plain "
                            f"argmin {want}")
            break
        fpf["rounds_equal" if got == want else "rounds_near_tie"] += 1
    log(f"MIND pruned index vs plain: bucket_score_tiled at probes "
        f"{bst['probes']} max |err| {bst['max_abs_err']:.3g}, ids equal on "
        f"{bst['rows_checked']}/{bst['rows']} rows free of near ties; "
        f"fpf_iter on the build's sample (m = {m}, D = {fpf['d']}) max "
        f"|maxsim err| {fpf['max_abs_err']:.3g}; a whole run's {kc - 1} "
        f"rounds: {fpf['rounds_equal']} centers equal the plain argmin, "
        f"{fpf['rounds_near_tie']} within {FPF_ATOL} of it")
    return {"bucket_score_tiled": bst, "fpf_iter": fpf}


def recsys_path(dev, zero_counts, read_counts, uncounted) -> dict:
    """Path H: the recsys serving path at published widths. Returns its
    numbers (``json``), its gate failures and the embed_bag row of the
    kernels line."""
    import gc

    import torch
    from torch.nn import functional as F

    from repro_torch.benchmarks.common import timed_all
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import (recsys_retrieval_step,
                                            recsys_serve_step)
    from repro_torch.core import brute_force_topk
    from repro_torch.data import RecsysBatchConfig, click_batch, history_batch
    from repro_torch.examples import recsys_retrieval
    from repro_torch.kernels import embed_bag, embed_bag_ref
    from repro_torch.models import recsys as rs

    failures = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dfull = get_arch("dlrm-mlperf").make_config()
    cfgs = {
        "dlrm-mlperf": dataclasses.replace(dfull, vocab_sizes=tuple(
            min(v, DLRM_ROW_CAP) for v in dfull.vocab_sizes)),
        "autoint": get_arch("autoint").make_config(),
        "bst": get_arch("bst").make_config(),
        "mind": get_arch("mind").make_config(),
    }
    dcfg, mcfg = cfgs["dlrm-mlperf"], cfgs["mind"]
    reduced = {
        "dlrm_row_cap": DLRM_ROW_CAP,
        "capped_tables": {f"table_{i}": [v, min(v, DLRM_ROW_CAP)]
                          for i, v in enumerate(dfull.vocab_sizes)
                          if v > DLRM_ROW_CAP},
        "rows": sum(dcfg.vocab_sizes), "uncapped_rows": sum(dfull.vocab_sizes),
    }
    param_bytes = {a: 4 * sum(int(np.prod(sh))
                              for sh in rs.param_specs(c).values())
                   for a, c in cfgs.items()}
    free0 = torch.cuda.mem_get_info(dev)[0]
    log(f"recsys path: card free {free0 / 1e9:.1f} GB; parameters "
        + ", ".join(f"{a} {v / 1e9:.2f} GB" for a, v in param_bytes.items())
        + f"; DLRM capped at {DLRM_ROW_CAP} rows: {reduced['rows']} rows of "
        f"{reduced['uncapped_rows']} ({len(reduced['capped_tables'])} tables "
        f"capped)")
    if sum(param_bytes.values()) + (2 << 30) > free0:
        fail(f"recsys path: the four models need {sum(param_bytes.values())} "
             f"bytes, {free0} are free on the card")
    classes = {"dlrm-mlperf": rs.DLRM, "autoint": rs.AutoInt, "bst": rs.BST,
               "mind": rs.MIND}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = {a: classes[a](c, device=dev, generator=torch.Generator(
        device=dev).manual_seed(i)) for i, (a, c) in enumerate(cfgs.items())}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def on_card(**arrays):
        return {k_: torch.as_tensor(v, device=dev) for k_, v in arrays.items()}

    dense, sparse1, _ = click_batch(
        RecsysBatchConfig(vocab_sizes=dcfg.vocab_sizes), H_BATCH, step=0)
    dense8, sparse8, _ = click_batch(
        RecsysBatchConfig(vocab_sizes=dcfg.vocab_sizes,
                          multi_hot=H_MULTI_HOT), H_BATCH, step=0)
    _, asparse, _ = click_batch(
        RecsysBatchConfig(vocab_sizes=cfgs["autoint"].vocab_sizes), H_BATCH,
        step=0)
    bh, bt, _ = history_batch(cfgs["bst"].n_items, H_BATCH,
                              cfgs["bst"].seq_len, step=0)
    mh, mt, _ = history_batch(mcfg.n_items, H_BATCH, mcfg.hist_len, step=0)
    steps = {
        "dlrm-mlperf": ("dlrm-mlperf", on_card(dense=dense,
                                               sparse=sparse1[..., 0])),
        "dlrm-mlperf multi-hot": ("dlrm-mlperf",
                                  on_card(dense=dense8, sparse=sparse8)),
        "autoint": ("autoint", on_card(sparse=asparse[..., 0])),
        "bst": ("bst", on_card(hist=bh, target=bt)),
        "mind": ("mind", on_card(hist=mh, target=mt)),
    }
    mind = models["mind"]
    rng = np.random.default_rng(0)
    u_hist = steps["mind"][1]["hist"][:1]
    u_w = torch.as_tensor(rng.dirichlet([1.0] * mcfg.n_interests, 1)
                          .astype(np.float32), device=dev)
    cands = mind.p["item_emb"].detach()

    # counted: the five serve steps, retrieval_cand through the batched dot
    # and its topk_score yardstick
    zero_counts()
    torch.cuda.synchronize()
    outs = {name: recsys_serve_step(models[a], b)
            for name, (a, b) in steps.items()}
    rv, ri = recsys_retrieval_step(mind, u_hist, cands, weights=u_w,
                                   k=H_TOPK)
    with torch.inference_mode():
        u_q = torch.einsum("bk,bke->be", u_w, mind(u_hist))
    bv, bi = brute_force_topk(cands, u_q, H_TOPK + 1)
    torch.cuda.synchronize()
    serve_launches = read_counts()
    want = {"fpf_iter": 0, "bucket_score_tiled": 0, "topk_score": 1,
            "bucket_score": 0, "embed_bag": dcfg.n_sparse}
    if serve_launches != want:
        failures.append(f"serve launches {serve_launches}, expected {want} "
                        f"({dcfg.n_sparse} embed_bag for the one multi-hot "
                        f"forward, 1 topk_score)")
    for name, out in outs.items():
        if out.shape != (H_BATCH,) or not bool(torch.isfinite(out).all()):
            failures.append(f"{name}: serve output {tuple(out.shape)}, "
                            f"finite {bool(torch.isfinite(out).all())}")
    r_ok, r_pos = ids_agree(ri[0].cpu().numpy(), bi[0].cpu().numpy(),
                            bv[0].cpu().numpy(), H_TOPK)
    r_err = float((rv[0] - bv[0, :H_TOPK]).abs().max())
    if not r_ok or r_err > RETRIEVAL_ATOL:
        failures.append(f"retrieval_cand top-{H_TOPK}: ids agree {r_ok} on "
                        f"{r_pos} clear positions, max |score diff| {r_err}")

    # the multi-hot forward against the same forward with the plain
    # embed_bag, and each table's call against its plain version (not
    # counted)
    dlrm = models["dlrm-mlperf"]
    mh_batch = steps["dlrm-mlperf multi-hot"][1]
    real = rs.embed_bag
    rs.embed_bag = (lambda t, i, w=None, *, combiner="sum":
                    embed_bag_ref(t, i, w, combiner=combiner))
    try:
        plain_logits = recsys_serve_step(dlrm, mh_batch)
    finally:
        rs.embed_bag = real
    logit_err = float((outs["dlrm-mlperf multi-hot"]
                       - plain_logits).abs().max())
    if logit_err > RECSYS_ATOL:
        failures.append(f"multi-hot DLRM logits: CUDA embed_bag vs plain "
                        f"differ by {logit_err} (tolerance {RECSYS_ATOL})")
    tables = [dlrm.p[f"table_{i}"].detach() for i in range(dcfg.n_sparse)]
    idxs = [mh_batch["sparse"][:, i].contiguous()
            for i in range(dcfg.n_sparse)]
    idxs64 = [x.long() for x in idxs]
    eb_err = max(float((uncounted("embed_bag", lambda: embed_bag(t, x))
                        - embed_bag_ref(t, x)).abs().max())
                 for t, x in zip(tables, idxs))
    lib_err = max(float((F.embedding_bag(x, t, mode="sum")
                         - embed_bag_ref(t, x)).abs().max())
                  for t, x in zip(tables, idxs64))
    if eb_err > H_EMBED_ATOL:
        failures.append(f"embed_bag vs plain at DLRM's multi-hot shape: "
                        f"{eb_err}")

    def kernel26():
        for t, x in zip(tables, idxs):
            embed_bag(t, x)

    def library26():
        for t, x in zip(tables, idxs64):
            F.embedding_bag(x, t, mode="sum")

    def plain26():
        for t, x in zip(tables, idxs):
            embed_bag_ref(t, x)

    # in turns: kernel, library, library, kernel; then device time from a
    # CUDA graph of the 26 calls
    eb26 = [uncounted("embed_bag", lambda: events_ms(kernel26))]
    lib26 = [events_ms(library26), events_ms(library26)]
    eb26.append(uncounted("embed_bag", lambda: events_ms(kernel26)))
    plain26_ms = events_ms(plain26)
    eb26_dev = uncounted("embed_bag", lambda: graph_ms(kernel26, reps=20))
    try:
        lib26_dev = graph_ms(library26, reps=20)
    except RuntimeError as e:       # a library call that cannot be captured
        lib26_dev = None
        log(f"F.embedding_bag in a CUDA graph: not measured ({e})")
    # the least time of the 26 calls: each table's distinct rows read once,
    # the int32 ids read and the (B, E) bags written once; 2 flops per
    # (slot, element)
    uniq = sum(int(torch.unique(x).numel()) for x in idxs)
    e = dcfg.embed_dim
    eb_bytes = uniq * e * 4 + sum(x.numel() * 4 for x in idxs) + (
        dcfg.n_sparse * H_BATCH * e * 4)
    eb_flops = 2 * sum(x.numel() for x in idxs) * e
    eb_bound26 = max(eb_bytes / HBM_BYTES_PER_S, eb_flops / FP32_FLOPS) * 1e3
    eb_by = ("bytes" if eb_bytes / HBM_BYTES_PER_S >= eb_flops / FP32_FLOPS
             else "operations")
    fwd_ms = {name: uncounted("embed_bag", lambda: events_ms(
        lambda: recsys_serve_step(models[a], b)))
        for name, (a, b) in steps.items()}
    dot_ms = events_ms(lambda: recsys_retrieval_step(
        mind, u_hist, cands, weights=u_w, k=H_TOPK))
    log(f"recsys serve (batch {H_BATCH}, CUDA events, median of 10, ms per "
        f"forward): " + ", ".join(f"{k_} {v:.4f}" for k_, v in fwd_ms.items())
        + f"; models made in {init_s:.2f} s; launches {serve_launches}")
    log(f"embed_bag at DLRM's multi-hot shape ({dcfg.n_sparse} tables, "
        f"B={H_BATCH}, L={H_MULTI_HOT}, E={e}): {dcfg.n_sparse} calls "
        f"{eb26[0]:.4f} / {eb26[1]:.4f} ms (F.embedding_bag {lib26[0]:.4f} / "
        f"{lib26[1]:.4f}, in turns); device time (CUDA graph) "
        f"{eb26_dev:.4f} (F.embedding_bag {lib26_dev}); plain "
        f"{plain26_ms:.4f}; bound {eb_bound26:.5f} by {eb_by} "
        f"({eb_bytes / 1e6:.2f} MB, {uniq} distinct rows of "
        f"{sum(x.numel() for x in idxs)} slots); max |err| vs plain {eb_err:.3g}"
        f" (F.embedding_bag {lib_err:.3g}); logits vs the plain forward "
        f"{logit_err:.3g}")
    log(f"retrieval_cand: {mcfg.n_items} candidates, top-{H_TOPK} by the "
        f"batched dot {dot_ms:.4f} ms; equal to topk_score on {r_pos} clear "
        f"positions ({r_ok}), max |score diff| {r_err:.3g}")
    del models, dlrm, tables, idxs, idxs64, outs, plain_logits, steps
    del mh_batch
    gc.collect()
    torch.cuda.empty_cache()

    # counted: the example's pruned retrieval over the full candidate set
    # (the MIND model, its interests, tiled docs, topk_score ground truth,
    # the fpf_fused build, calibration, 8 planned requests)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = recsys_retrieval.run(mcfg, H_K_CLUSTERS, device=dev)
    torch.cuda.synchronize()
    ex_s = time.perf_counter() - t0
    ex_launches = read_counts()
    retriever = ex["retriever"]
    grid = retriever.index.ladder.probes
    want = {"fpf_iter": 3, "bucket_score_tiled": len(grid) + 2,
            "topk_score": 1, "bucket_score": 0, "embed_bag": 0}
    if ex_launches != want:
        failures.append(f"retrieval launches {ex_launches}, expected {want} "
                        f"(3 FPF runs; {len(grid)} sweep levels, the exact "
                        f"tier and the request batch; 1 brute force)")
    if ex["recall"] < ex["predicted_recall"] - RECALL_SLACK:
        failures.append(f"pruned MIND retrieval: achieved recall "
                        f"{ex['recall']:.4f} below predicted "
                        f"{ex['predicted_recall']:.4f} - {RECALL_SLACK}")
    docs, qw, requests = ex["docs"], ex["qw"], ex["requests"]
    checks = pruned_kernel_checks(retriever, requests, grid, ex["probes"],
                                  uncounted, failures)
    data = retriever.index.ensure_bucket_major()[0]
    pack_bytes = data.numel() * data.element_size()
    del data

    def pruned():
        retriever._flush_request_caches()
        return retriever.search(requests)

    pruned_ms = [1e3 * s_ for s_ in uncounted("bucket_score_tiled", lambda:
                 timed_all(pruned, dev, repeats=10, warmup=1)[0])]
    brute_ms = uncounted("topk_score", lambda: events_ms(
        lambda: brute_force_topk(docs, qw, recsys_retrieval.TOP_K)))
    log(f"MIND pruned retrieval: {mcfg.n_items} items, D = {docs.shape[1]}, "
        f"K = {H_K_CLUSTERS}, T = 3, B = {retriever.index.buckets.shape[-1]} "
        f"(pack {pack_bytes / 1e9:.2f} GB), built and calibrated in "
        f"{ex['build_s']:.2f} s (example {ex_s:.1f} s); "
        f"{recsys_retrieval.USERS} users at "
        f"recall_target=0.9: {ex['probes']} probes, predicted "
        f"{ex['predicted_recall']:.4f}, achieved {ex['recall']:.4f}, "
        f"scanning {ex['scanned']:.1%}; {np.median(pruned_ms):.2f} ms a batch "
        f"(host wall, median of 10) against brute force {brute_ms:.4f} ms "
        f"(topk_score); launches {ex_launches}")
    out = {
        "reduced": reduced, "batch": H_BATCH, "multi_hot": H_MULTI_HOT,
        "forward_ms": fwd_ms, "models_s": init_s,
        "launches": {"serve": serve_launches, "retrieval": ex_launches},
        "embed_bag": {
            "calls": dcfg.n_sparse, "ms": eb26, "library_ms": lib26,
            "device_ms": eb26_dev, "library_device_ms": lib26_dev,
            "plain_ms": plain26_ms, "bound_ms": eb_bound26, "bound_by": eb_by,
            "bytes": eb_bytes, "distinct_rows": uniq,
            "max_abs_err": eb_err, "library_max_abs_err": lib_err,
            "logits_max_abs_diff": logit_err},
        "retrieval_cand": {"n_items": mcfg.n_items, "k": H_TOPK,
                           "batched_dot_ms": dot_ms, "ids_agree": r_ok,
                           "clear_positions": r_pos,
                           "max_abs_diff": r_err},
        "pruned_kernels_vs_plain": checks,
        "pruned": {"users": recsys_retrieval.USERS,
                   "k": recsys_retrieval.TOP_K,
                   "k_clusters": H_K_CLUSTERS,
                   "b": int(retriever.index.buckets.shape[-1]),
                   "recall": ex["recall"],
                   "predicted_recall": ex["predicted_recall"],
                   "probes": ex["probes"], "scanned": ex["scanned"],
                   "build_s": ex["build_s"], "ms": pruned_ms,
                   "brute_ms": brute_ms},
        "card_bytes": {"free_at_start": free0, "params": param_bytes,
                       "mind_docs": docs.numel() * 4, "mind_pack": pack_bytes,
                       "peak_allocated": torch.cuda.max_memory_allocated(dev)},
    }
    row = {"launches": serve_launches["embed_bag"], "max_abs_err": eb_err,
           "ms": eb26[0] / dcfg.n_sparse, "plain_ms": plain26_ms / dcfg.n_sparse,
           "bound_ms": eb_bound26 / dcfg.n_sparse, "bound_by": eb_by,
           "library_ms": lib26[0] / dcfg.n_sparse}
    del ex, retriever, docs, qw, requests, cands, mind
    gc.collect()
    torch.cuda.empty_cache()
    return {"json": out, "failures": failures, "embed_bag_row": row}


def train_runs():
    """Path I's runs: ``(name, model class, config, multi_hot)`` at
    ``make_config()`` widths, DLRM's tables capped at I_ROW_CAP rows."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as rs

    dfull = get_arch("dlrm-mlperf").make_config()
    dcfg = dataclasses.replace(dfull, vocab_sizes=tuple(
        min(v, I_ROW_CAP) for v in dfull.vocab_sizes))
    return [("dlrm-mlperf", rs.DLRM, dcfg, 1),
            ("dlrm-mlperf multi-hot", rs.DLRM, dcfg, I_MULTI_HOT),
            ("autoint", rs.AutoInt, get_arch("autoint").make_config(), 1),
            ("bst", rs.BST, get_arch("bst").make_config(), 1),
            ("mind", rs.MIND, get_arch("mind").make_config(), 1)]


def train_host_batches(cfg, multi_hot: int) -> list:
    """Steps 0..I_STEPS of the reference's generators at I_BATCH, on the
    host: ``click_batch`` for DLRM and AutoInt (one-hot: the first id of
    each field), ``history_batch`` for BST and MIND."""
    from repro_torch.data import RecsysBatchConfig, click_batch, history_batch
    from repro_torch.models import recsys as rs

    out = []
    for step in range(1 + I_STEPS):
        if isinstance(cfg, (rs.DLRMConfig, rs.AutoIntConfig)):
            dense, sparse, y = click_batch(RecsysBatchConfig(
                vocab_sizes=cfg.vocab_sizes, multi_hot=multi_hot),
                I_BATCH, step=step)
            b = {"sparse": sparse if multi_hot > 1 else sparse[..., 0],
                 "label": y}
            if isinstance(cfg, rs.DLRMConfig):
                b["dense"] = dense
        else:
            hl = cfg.seq_len if isinstance(cfg, rs.BSTConfig) else cfg.hist_len
            h, t, y = history_batch(cfg.n_items, I_BATCH, hl, step=step)
            b = {"hist": h, "target": t, "label": y}
        out.append(b)
    return out


def train_bytes(cfg, multi_hot: int) -> dict:
    """Bytes one training run of ``cfg`` needs on the card, reckoned on the
    host: parameters, dense gradients and two fp32 AdamW moments (4 copies),
    the optimizer's two temporaries of the largest tensor, the batches, and
    the activations at I_BATCH (the forward's saved tensors, twice for the
    backward's transients). DLRM multi-hot's gradient check runs before the
    optimizer's state exists; the larger of the two is the total."""
    from repro_torch.models import recsys as rs

    shapes = rs.param_specs(cfg).values()
    params = 4 * sum(int(np.prod(s)) for s in shapes)
    largest = 4 * max(int(np.prod(s)) for s in shapes)
    if isinstance(cfg, rs.DLRMConfig):
        f, e, n = cfg.n_sparse + 1, cfg.embed_dim, cfg.n_sparse
        fwd = (2 * sum(cfg.bot_mlp[1:]) + 3 * f * e + 2 * f * f
               + cfg.n_interact + 2 * sum(cfg.top_mlp))
        per_batch = 4 * (cfg.n_dense + 1) + 4 * n * multi_hot
        if multi_hot > 1:       # bags, int64 ids, one table's slot products
            fwd += n * e + 2 * n * multi_hot + multi_hot * e
    elif isinstance(cfg, rs.AutoIntConfig):
        f, e, d, h = cfg.n_fields, cfg.embed_dim, cfg.d_attn, cfg.n_heads
        fwd = 2 * f * e + cfg.n_attn_layers * (6 * f * d + 3 * h * f * f)
        per_batch = 4 * (cfg.n_fields + 1)
    elif isinstance(cfg, rs.BSTConfig):
        s, e, h = cfg.full_seq, cfg.embed_dim, cfg.n_heads
        fwd = (4 * s * e + cfg.n_blocks * (26 * s * e + 3 * h * s * s)
               + 2 * sum(cfg.mlp))
        per_batch = 4 * (s + 1)
    else:
        l_, e, k = cfg.hist_len, cfg.embed_dim, cfg.n_interests
        fwd = 3 * l_ * e + cfg.capsule_iters * (2 * l_ * e + 3 * k * l_) + (
            4 * k * e + e)
        per_batch = 4 * (l_ + 2)
    out = {"state": 4 * params, "optimizer_temps": 2 * largest,
           "batches": (1 + I_STEPS) * per_batch * I_BATCH,
           "activations": 2 * fwd * 4 * I_BATCH}
    out["total"] = sum(out.values())
    if isinstance(cfg, rs.DLRMConfig) and multi_hot > 1:
        # before the moments exist: parameters, both steps' gradients, and
        # one table's gathered rows at a time in the plain forward
        out["grad_check"] = (3 * params + out["activations"] + out["batches"]
                             + 2 * multi_hot * cfg.embed_dim * 4 * I_BATCH)
        out["total"] = max(out["total"], out["grad_check"])
    return out


def train_path(dev, zero_counts, read_counts, uncounted) -> dict:
    """Path I: recsys training at train_batch on the card. Returns its
    numbers (``json``) and its gate failures; a run that does not fit the
    card as reckoned ends the smoke at once."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.common import (recsys_loss_and_grads,
                                            recsys_model_flops,
                                            recsys_train_step)
    from repro_torch.data import history_batch
    from repro_torch.kernels import embed_bag_ref
    from repro_torch.models import recsys as rs
    from repro_torch.optim import adamw

    failures = []
    gc.collect()
    torch.cuda.empty_cache()
    dfull = get_arch("dlrm-mlperf").make_config()
    runs = train_runs()
    dcfg = runs[0][2]
    reduced = {
        "dlrm_row_cap": I_ROW_CAP,
        "capped_tables": {f"table_{i}": [v, min(v, I_ROW_CAP)]
                          for i, v in enumerate(dfull.vocab_sizes)
                          if v > I_ROW_CAP},
        "rows": sum(dcfg.vocab_sizes), "uncapped_rows": sum(dfull.vocab_sizes),
    }
    free0 = torch.cuda.mem_get_info(dev)[0]
    at_start = {"free": free0, "allocated": torch.cuda.memory_allocated(dev),
                "reserved": torch.cuda.memory_reserved(dev)}
    log(f"training path: card free {free0 / 1e9:.1f} GB (allocated "
        f"{at_start['allocated'] / 1e9:.2f}, reserved "
        f"{at_start['reserved'] / 1e9:.2f}); batch {I_BATCH}; DLRM capped at "
        f"{I_ROW_CAP} rows: {reduced['rows']} of {reduced['uncapped_rows']} "
        f"({len(reduced['capped_tables'])} tables capped)")

    def plain_forward(t, i, w=None, *, combiner="sum"):
        return embed_bag_ref(t, i, w, combiner=combiner)

    out_runs, grad_check, eb = {}, None, None
    for seed, (name, cls, cfg, mh) in enumerate(runs):
        host = train_host_batches(cfg, mh)
        need = train_bytes(cfg, mh)
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        log(f"training {name}: reckoned {need['total'] / 1e9:.2f} GB "
            f"({', '.join(f'{k} {v / 1e9:.2f}' for k, v in need.items())}), "
            f"free {free / 1e9:.2f} GB")
        if need["total"] > free:
            fail(f"training path: {name} needs {need['total']} bytes as "
                 f"reckoned, {free} are free on the card")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = cls(cfg, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
                   for b in host]
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.p.values())

        if mh > 1:
            # the gradients of one step with the CUDA embed_bag in the
            # forward against the same step with the plain one (not counted)
            _, g_k = uncounted("embed_bag", lambda: recsys_loss_and_grads(
                model, batches[0]))
            real, rs.embed_bag = rs.embed_bag, plain_forward
            try:
                _, g_p = recsys_loss_and_grads(model, batches[0])
            finally:
                rs.embed_bag = real
            rel = {}
            for n in g_k:
                scale = float(g_p[n].abs().max()) or 1.0
                rel[n] = float((g_k[n] - g_p[n]).abs().max()) / scale
            worst = max(rel, key=rel.get)
            grad_check = {"max_rel_err": rel[worst], "tensor": worst,
                          "rtol": I_GRAD_RTOL, "tensors": len(rel)}
            if rel[worst] > I_GRAD_RTOL:
                failures.append(f"multi-hot gradients with the CUDA "
                                f"embed_bag differ from the plain forward's: "
                                f"{worst} by {rel[worst]} of its largest "
                                f"value (tolerance {I_GRAD_RTOL})")
            del g_k, g_p
            eb = embed_bag_at_train_shape(model, cfg, batches[0], host[0],
                                          uncounted, failures)

        opt = adamw(1e-3)
        state = opt.init(dict(model.p))
        zero_counts()
        torch.cuda.synchronize()
        loss, state = recsys_train_step(model, opt, state, batches[0])
        losses, fb_ms, opt_ms, finite = [float(loss)], [], [], True
        for b in batches[1:]:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            loss, grads = recsys_loss_and_grads(model, b)
            ev[1].record()
            _, state = opt.update(grads, state, dict(model.p))
            ev[2].record()
            torch.cuda.synchronize()
            fb_ms.append(ev[0].elapsed_time(ev[1]))
            opt_ms.append(ev[1].elapsed_time(ev[2]))
            losses.append(float(loss))
            finite &= bool(torch.stack([torch.isfinite(g).all()
                                        for g in grads.values()]).all())
            del grads
        launches = read_counts()
        want = {k: 0 for k in launches}
        want["embed_bag"] = cfg.n_sparse * (1 + I_STEPS) if mh > 1 else 0
        if launches != want:
            failures.append(f"{name}: launches {launches} in {1 + I_STEPS} "
                            f"steps, expected {want}")
        if not (finite and np.isfinite(losses).all()):
            failures.append(f"{name}: losses {losses}, gradients finite "
                            f"{finite}")
        step_ms = [a + b for a, b in zip(fb_ms, opt_ms)]
        flops = recsys_model_flops(cfg, I_BATCH)
        opt_bound = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
        rate = flops / (float(np.median(step_ms)) * 1e-3)
        out_runs[name] = {
            "params": n_params, "multi_hot": mh, "reckoned_bytes": need,
            "free_bytes": free, "peak_allocated":
                torch.cuda.max_memory_allocated(dev),
            "made_s": made_s, "fwd_bwd_ms": fb_ms, "optimizer_ms": opt_ms,
            "step_ms": step_ms, "optimizer_bound_ms": opt_bound,
            "optimizer_bound_by": "bytes", "model_flops": flops,
            "model_flops_per_s": rate, "fp32_peak_share": rate / FP32_FLOPS,
            "losses": losses, "launches": launches}
        log(f"training {name}: {n_params} parameters; ms per step (CUDA "
            f"events) forward+backward {np.median(fb_ms):.2f}, optimizer "
            f"{np.median(opt_ms):.2f} (bound {opt_bound:.2f} by bytes); "
            f"{rate / 1e12:.2f} model TFLOP/s ({rate / FP32_FLOPS:.1%} of the "
            f"fp32 peak); losses {[round(x, 4) for x in losses]}; peak "
            f"allocated {out_runs[name]['peak_allocated'] / 1e9:.2f} GB "
            f"(reckoned {need['total'] / 1e9:.2f}); launches {launches}")
        del model, opt, state, batches, loss
        gc.collect()
        torch.cuda.empty_cache()

    # the reference's test_recsys_training_learns recipe on the card
    lcfg = rs.BSTConfig(n_items=1000, embed_dim=16, seq_len=10, n_blocks=1,
                        n_heads=4, mlp=(32,))
    lm = rs.BST(lcfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    lopt = adamw(I_LEARN["lr"])
    lstate = lopt.init(dict(lm.p))
    learn = []
    for i in range(I_LEARN["steps"]):
        h, t, y = history_batch(lcfg.n_items, I_LEARN["batch"], lcfg.seq_len,
                                step=i)
        loss, lstate = recsys_train_step(lm, lopt, lstate, {
            "hist": torch.as_tensor(h, device=dev),
            "target": torch.as_tensor(t, device=dev),
            "label": torch.as_tensor(y, device=dev)})
        learn.append(float(loss))
    first, last = float(np.mean(learn[:10])), float(np.mean(learn[-10:]))
    if not last < first - I_LEARN["margin"]:
        failures.append(f"BST did not learn: mean of the last 10 losses "
                        f"{last:.4f}, of the first 10 {first:.4f}")
    log(f"BST learning recipe ({I_LEARN['steps']} steps of "
        f"{I_LEARN['batch']}, adamw({I_LEARN['lr']})): first 10 {first:.4f}, "
        f"last 10 {last:.4f}; grad check {grad_check}")
    del lm, lstate
    return {"json": {"batch": I_BATCH, "reduced": reduced,
                     "card_at_start": at_start, "runs": out_runs,
                     "grad_check": grad_check, "embed_bag": eb,
                     "learn": {"first10": first, "last10": last,
                               "losses": learn}},
            "failures": failures}


def embed_bag_at_train_shape(model, cfg, batch, host_batch, uncounted,
                             failures) -> dict:
    """The 26 tables' embed_bag calls at the training shape (B = I_BATCH,
    L = I_MULTI_HOT, E = 128), not counted: each against its plain version,
    the forward against 26 F.embedding_bag in turns and as device time, the
    plain backward (embed_bag_backward) against F.embedding_bag's autograd
    backward, each beside its bound."""
    import torch
    from torch.nn import functional as F

    from repro_torch.kernels import embed_bag, embed_bag_ref
    from repro_torch.models.embedding import embed_bag_backward

    n, e = cfg.n_sparse, cfg.embed_dim
    tables = [model.p[f"table_{i}"].detach() for i in range(n)]
    idxs = [batch["sparse"][:, i].contiguous() for i in range(n)]
    idxs64 = [x.long() for x in idxs]
    err = max(float((uncounted("embed_bag", lambda: embed_bag(t, x))
                     - embed_bag_ref(t, x)).abs().max())
              for t, x in zip(tables, idxs))
    if err > H_EMBED_ATOL:
        failures.append(f"embed_bag vs plain at the training shape: {err}")

    def kernel26():
        for t, x in zip(tables, idxs):
            embed_bag(t, x)

    def library26():
        for t, x in zip(tables, idxs64):
            F.embedding_bag(x, t, mode="sum")

    def plain26():
        for t, x in zip(tables, idxs):
            embed_bag_ref(t, x)

    fwd = [uncounted("embed_bag", lambda: events_ms(kernel26))]
    lib = [events_ms(library26), events_ms(library26)]
    fwd.append(uncounted("embed_bag", lambda: events_ms(kernel26)))
    plain = events_ms(plain26, reps=3)
    fwd_dev = uncounted("embed_bag", lambda: graph_ms(kernel26, reps=4))
    try:
        lib_dev = graph_ms(library26, reps=4)
    except RuntimeError as ex:      # a library call that cannot be captured
        lib_dev = None
        log(f"F.embedding_bag in a CUDA graph: not measured ({ex})")
    g = torch.Generator(device=tables[0].device).manual_seed(23)
    gouts = [torch.randn(I_BATCH, e, device=tables[0].device, generator=g)
             for _ in tables]

    def backward26():
        for t, x, go in zip(tables, idxs, gouts):
            embed_bag_backward(t, x, None, go)

    bwd = events_ms(backward26, reps=5)
    leaves = [t.detach().requires_grad_() for t in tables]
    outs = [F.embedding_bag(x, t, mode="sum") for x, t in zip(idxs64, leaves)]
    lib_bwd = events_ms(lambda: torch.autograd.grad(
        outs, leaves, gouts, retain_graph=True), reps=5)
    del outs, leaves, gouts
    # bounds: the forward reads each table's distinct rows once (counted on
    # the host), the int32 ids, and writes the bags; the backward reads the
    # ids and the bags' gradients and writes the dense (V, E) gradients;
    # 2 flops per (slot, element) each way
    slots = sum(x.numel() for x in idxs)
    uniq = sum(len(np.unique(host_batch["sparse"][:, i])) for i in range(n))
    bags = n * I_BATCH * e * 4
    f_bytes = uniq * e * 4 + slots * 4 + bags
    b_bytes = sum(cfg.vocab_sizes) * e * 4 + slots * 4 + bags
    flops = 2 * slots * e

    def bound(nbytes):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    (f_bound, f_by), (b_bound, b_by) = bound(f_bytes), bound(b_bytes)
    log(f"embed_bag at the training shape ({n} tables, B={I_BATCH}, "
        f"L={I_MULTI_HOT}, E={e}): the {n} forward calls {fwd[0]:.3f} / "
        f"{fwd[1]:.3f} ms (F.embedding_bag {lib[0]:.3f} / {lib[1]:.3f}, in "
        f"turns), device time {fwd_dev:.3f} (F.embedding_bag {lib_dev}), "
        f"plain {plain:.3f}, bound {f_bound:.4f} by {f_by} ({uniq} distinct "
        f"rows of {slots} slots, {f_bytes / 1e9:.3f} GB); backward (plain) "
        f"{bwd:.3f} ms vs F.embedding_bag's {lib_bwd:.3f}, bound "
        f"{b_bound:.4f} by {b_by} ({b_bytes / 1e9:.3f} GB); max |err| vs "
        f"plain {err:.3g}")
    return {"calls": n, "forward_ms": fwd, "library_ms": lib,
            "device_ms": fwd_dev, "library_device_ms": lib_dev,
            "plain_ms": plain, "forward_bound_ms": f_bound,
            "forward_bound_by": f_by, "forward_bytes": f_bytes,
            "distinct_rows": uniq, "slots": slots, "backward_ms": bwd,
            "library_backward_ms": lib_bwd, "backward_bound_ms": b_bound,
            "backward_bound_by": b_by, "backward_bytes": b_bytes,
            "max_abs_err": err}


def paths_a_to_h():
    """Paths A-H and their gates. Returns 2 without a card or a checkout,
    else what ``main`` prints after path I (the tensors of A-H are freed
    when it returns)."""
    try:
        import torch
    except ImportError:
        print("[chip_smoke] torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    from repro_torch.core import (
        CellDecIndex, ClusterPruneIndex, Retriever, brute_force_bottomk,
        brute_force_topk, calibrate_index, competitive_recall, get_engine,
        normalized_aggregate_goodness, weighted_query,
    )
    from repro_torch.core.cluster import (
        _medoids, assign_to_centers, fpf_sample_size, get_clusterer)
    from repro_torch.core.engine import ShardedEngine
    from repro_torch.core.index import pack_buckets, pack_buckets_major
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.core.api import decompose_scores
    from repro_torch.kernels import (
        bucket_score, bucket_score_ref, bucket_score_tiled,
        bucket_score_tiled_ref, build_probe_schedule_device, embed_bag,
        embed_bag_ref, fpf_centers_fused, fpf_iter, fpf_iter_ref,
        pack_bucket_major, pick_query_tile, schedule_length, topk_score,
        topk_score_ref,
    )
    from repro_torch.kernels.bucket_score.ops import (
        V1_GROUP, TiledCall, V1Call)
    from repro_torch.kernels.common import build_cuda_library, resolve_device
    from repro_torch.launch import kernels_bench
    from repro_torch.launch.serve import make_requests

    wrappers = {"fpf_iter": fpf_iter, "bucket_score_tiled": bucket_score_tiled,
                "topk_score": topk_score, "bucket_score": bucket_score,
                "embed_bag": embed_bag}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        fpf_iter.rounds = 0
        topk_score.tc_launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    def uncounted(name, fn):
        """Call ``fn`` without adding its launches to ``name``'s count, or
        its rounds to ``fpf_iter``'s (comparisons with the plain version,
        timing loops and the build replay)."""
        before = (wrappers[name].launches, fpf_iter.rounds,
                  topk_score.tc_launches)
        try:
            return fn()
        finally:
            (wrappers[name].launches, fpf_iter.rounds,
             topk_score.tc_launches) = before

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    built: dict = {}

    def nvcc(name):
        try:
            built[name] = build_cuda_library(name)
        except Exception as e:          # reported below, fails the run
            built[name] = e

    threads = [threading.Thread(target=nvcc, args=(name,))
               for name in CUDA_SOURCES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in CUDA_SOURCES:
        if isinstance(built[name], Exception):
            fail(f"nvcc build of {name} failed: {built[name]}")
    build_s = time.perf_counter() - t0
    for name in CUDA_SOURCES:
        with open(built[name] + ".ptxas.txt") as f:
            regs = [ln.strip() for ln in f
                    if "registers" in ln or "spill" in ln]
        log(f"ptxas {name}: {regs}")
    log(f"kernels built in {build_s:.1f}s ({len(CUDA_SOURCES)} nvcc in "
        f"parallel)")

    # ------------------------------------------------------ 2. main path
    t0 = time.perf_counter()
    docs_np, spec, _ = make_corpus(CorpusConfig(n_docs=N_DOCS, seed=0))
    log(f"corpus {docs_np.shape} made in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    qids = rng.choice(N_DOCS, N_QUERIES, replace=False)
    w = rng.dirichlet([1.0] * spec.s, size=N_QUERIES).astype(np.float32)

    zero_counts()
    fused_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    retriever = Retriever.build(
        docs_np, spec, K_CLUSTERS, n_clusterings=T, method="auto",
        device=dev, generator=torch.Generator().manual_seed(0),
        backend="fused",
    )
    torch.cuda.synchronize()
    build_index_s = time.perf_counter() - t0
    index = retriever.index
    b = int(index.buckets.shape[2])
    log(f"index built in {build_index_s:.2f}s: method={index.method}, "
        f"T={T}, K={K_CLUSTERS}, B={b} (mean bucket {N_DOCS / K_CLUSTERS:.0f})")
    if index.method != "fpf_fused":
        fail(f"method='auto' resolved to {index.method!r}, not fpf_fused")

    reqs = make_requests(qids, w, spec, probes=PROBES, k=K, backend="fused")
    t0 = time.perf_counter()
    fused = retriever.search(reqs)
    first_batch_s = time.perf_counter() - t0          # includes the pack
    fused_calls += 1
    data, _, _ = index.ensure_bucket_major()
    pack_bytes = data.numel() * data.element_size()
    log(f"fp32 bucket-major pack: {tuple(data.shape)}, {pack_bytes / 1e9:.2f} GB")
    retriever._flush_request_caches()
    t0 = time.perf_counter()
    fused = retriever.search(reqs)
    batch_s = time.perf_counter() - t0
    fused_calls += 1
    exact_reqs = make_requests(qids, w, spec, k=K, backend="fused",
                               exact=True)
    t0 = time.perf_counter()
    exact = retriever.search(exact_reqs)
    exact_s = time.perf_counter() - t0
    fused_calls += 1
    quant = {}
    for pack_dtype in OVERLAP_FLOORS:
        qidx = dataclasses.replace(index, bucket_data=None,
                                   bucket_scales=None, pack_dtype=pack_dtype)
        qret = Retriever(qidx, backend="fused")
        quant[pack_dtype] = (qidx, qret.search(reqs))
        fused_calls += 1
    # the exact tier on the int8 pack: kernel at depth 4k, then the fp32
    # rescore tail
    t0 = time.perf_counter()
    exact_int8 = Retriever(quant["int8"][0], backend="fused").search(
        exact_reqs)
    exact_int8_s = time.perf_counter() - t0
    fused_calls += 1
    torch.cuda.synchronize()
    launches = read_counts()
    fpf_rounds = fpf_iter.rounds
    log(f"main path launches: {launches} ({fused_calls} fused engine calls; "
        f"fpf_iter ran {fpf_rounds} rounds)")
    log(f"first fused batch (packs the index) {first_batch_s * 1e3:.1f} ms; "
        f"64-request fused batch {batch_s * 1e3:.1f} ms "
        f"(engine + decomposition {fused[0].compute_s * 1e3:.1f} ms)")

    log(f"exact tier (all {T * K_CLUSTERS} buckets): fp32 pack "
        f"{exact_s * 1e3:.1f} ms, int8 pack + fp32 rescore "
        f"{exact_int8_s * 1e3:.1f} ms per 64-request batch")
    t0 = time.perf_counter()
    ref = retriever.search(
        make_requests(qids, w, spec, probes=PROBES, k=K, backend="reference"))
    log(f"reference backend, same index and requests: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms per batch")
    f_ids = np.stack([r.doc_ids for r in fused])
    f_sc = np.stack([r.scores for r in fused])
    r_ids = np.stack([r.doc_ids for r in ref])
    r_sc = np.stack([r.scores for r in ref])

    # --------------------------------------------- quality path (B)
    qw = weighted_query(index.docs[torch.as_tensor(qids, device=dev)],
                        torch.as_tensor(w), spec)
    excl = torch.as_tensor(qids, dtype=torch.int32, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ladder = calibrate_index(index, backend="fused")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_launches = read_counts()
    log(f"calibrate_index (fused, 64 queries x 6 draws, k={K}) in "
        f"{calib_s:.2f}s: probes->recall "
        + ", ".join(f"{p}->{r:.4f}" for p, r in zip(ladder.probes,
                                                     ladder.recall))
        + f"; measured {[round(x, 4) for x in ladder.meta['measured_recall']]}")
    served = {}
    for target in RECALL_TARGETS:
        t0 = time.perf_counter()
        planned = retriever.search(make_requests(
            qids, w, spec, recall_target=target, k=K, backend="fused"))
        planned_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        floored = retriever.search(make_requests(
            qids, w, spec, probes=PROBES, k=K, backend="fused",
            min_recall=target))
        served[target] = (planned, floored, planned_s,
                          time.perf_counter() - t0)
    # ground truth at k+1 so the id checks can skip genuine near ties
    gt_s, gt_i = brute_force_topk(index.docs, qw, K + 1, exclude=excl)
    far_s, _ = brute_force_bottomk(index.docs, qw, K, exclude=excl)
    torch.cuda.synchronize()
    quality_launches = read_counts()
    quality_tc = topk_score.tc_launches
    brute_calls = 2
    log(f"quality path launches: {quality_launches} (calibration alone "
        f"{calib_launches})")
    gt_s, gt_i = gt_s.cpu().numpy(), gt_i.cpu().numpy()
    gt_k = torch.as_tensor(gt_i[:, :K])

    def achieved(resps) -> float:
        ids = torch.as_tensor(np.stack([r.doc_ids for r in resps]))
        return float(competitive_recall(ids, gt_k).mean()) / K

    total = T * K_CLUSTERS

    def ladder_budgets(floor):
        """The budgets search_escalating runs from probes=PROBES."""
        budgets, p = [], PROBES
        while True:
            budgets.append(p)
            if p >= total or ladder.predicted_recall(p) >= floor:
                return budgets
            above = next((r for r in ladder.probes if r > p), total)
            nxt = min(max(above, ladder.plan(floor)), total)
            p = nxt if nxt > p else total

    for target, (planned, floored, planned_s, floored_s) in served.items():
        tiers: dict = {}
        for r in floored:
            tiers[r.tier] = tiers.get(r.tier, 0) + 1
        log(f"recall_target={target}: planned {planned[0].probes} probes "
            f"(ladder.plan {ladder.plan(target)}), predicted "
            f"{planned[0].predicted_recall:.4f}, achieved "
            f"{achieved(planned):.4f}, {planned_s * 1e3:.1f} ms per batch; "
            f"min_recall={target} from probes={PROBES}: ladder budgets "
            f"{ladder_budgets(target)}, tiers {tiers}, "
            f"{sum(r.escalations for r in floored)} escalations, predicted "
            f"{floored[0].predicted_recall:.4f}, achieved "
            f"{achieved(floored):.4f}, {floored_s * 1e3:.1f} ms per batch")
    ref_k1 = get_engine(index, "reference").search(
        qw, probes=PROBES, k=K + 1, exclude=excl)[0].cpu().numpy()
    cr = float(competitive_recall(torch.as_tensor(f_ids), gt_k).mean())
    nag = float(normalized_aggregate_goodness(
        torch.as_tensor(f_sc), torch.as_tensor(gt_s[:, :K]),
        far_s.cpu()).mean())
    log(f"quality at probes={PROBES}: CR {cr:.2f}/{K}, NAG {nag:.4f}, "
        f"scored {np.mean([r.n_scored for r in fused]) / N_DOCS:.1%} of corpus")
    # ------------------------------------------ kernels-bench path (C)
    zero_counts()
    bench_rows = kernels_bench.run(dev)
    torch.cuda.synchronize()
    bench_launches = read_counts()
    log(f"kernels bench path launches: {bench_launches}")
    bench = {r["kernel"]: r for r in bench_rows}
    for r in bench_rows:
        log(f"kernels bench {r['kernel']} {r['shape']}: {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}), agrees {r['agrees']}, max |err| "
            f"{r['max_abs_err']:.3g}")

    # ------------------------------------------------------------ repairs
    # any D: a FieldSpec of (100, 100, 100); two builds of it bit-identical
    rdocs, rspec, _ = make_corpus(CorpusConfig(
        n_docs=REPAIR_DOCS, field_dims=REPAIR_DIMS, seed=1))
    k_rep = max(16, int(np.sqrt(REPAIR_DOCS)))
    rbuilds = [ClusterPruneIndex.build(
        rdocs, rspec, k_rep, n_clusterings=T, device=dev,
        generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    ridx = rbuilds[0]
    same_build = (torch.equal(rbuilds[0].leaders, rbuilds[1].leaders)
                  and torch.equal(rbuilds[0].buckets, rbuilds[1].buckets)
                  and np.array_equal(rbuilds[0].assign, rbuilds[1].assign))
    rrng = np.random.default_rng(2)
    rq = rrng.choice(REPAIR_DOCS, N_QUERIES, replace=False)
    rw = rrng.dirichlet([1.0] * rspec.s, size=N_QUERIES).astype(np.float32)
    rqw = weighted_query(ridx.docs[torch.as_tensor(rq, device=dev)],
                         torch.as_tensor(rw), rspec)
    rex = torch.as_tensor(rq, dtype=torch.int32, device=dev)
    d300 = [x.cpu().numpy() for x in get_engine(ridx, "fused").search(
        rqw, probes=PROBES, k=K, exclude=rex)]
    r300 = [x.cpu().numpy() for x in get_engine(ridx, "reference").search(
        rqw, probes=PROBES, k=K + 1, exclude=rex)]
    ok300 = rows_without_near_ties(r300[0])
    d300_ok = (np.array_equal(d300[1][ok300], r300[1][ok300, :K])
               and np.allclose(d300[0], r300[0][:, :K], atol=SCORE_ATOL)
               and np.array_equal(d300[2], r300[2]))
    # the bf16 pack at D = 300 rows fill no whole 16-byte words: the
    # kernel's value-by-value loads against the plain version
    r16 = dataclasses.replace(ridx, bucket_data=None, bucket_scales=None,
                              pack_dtype="bfloat16")
    _, a300, k300 = get_engine(r16, "fused").kernel_inputs(
        rqw, probes=PROBES, k=K, exclude=rex)
    s_k, i_k = bucket_score_tiled(*a300, **k300)
    s_p, i_p = bucket_score_tiled_ref(*a300, **k300)
    err300 = float((s_k - s_p).abs().max())
    ov300 = overlap(i_k.cpu().numpy(), i_p.cpu().numpy())
    # a query tile of 32 runs as two sub-tiles of 16: the same answers
    t32 = get_engine(index, "fused", query_tile=32).search(
        qw, probes=PROBES, k=K, exclude=excl)
    t16 = get_engine(index, "fused").search(qw, probes=PROBES, k=K,
                                            exclude=excl)
    qt32_ok = (torch.equal(t32[1], t16[1]) and torch.equal(t32[2], t16[2])
               and float((t32[0] - t16[0]).abs().max()) <= SCORE_ATOL)
    log(f"repairs: D=300 ({REPAIR_DOCS} docs, K={k_rep}) fused == reference "
        f"on {int(ok300.sum())}/{N_QUERIES} rows free of near ties: "
        f"{d300_ok}; bf16 D=300 kernel vs plain err {err300:.3g}, overlap "
        f"{ov300:.4f}; query_tile=32 == default tile: {qt32_ok}; two builds "
        f"bit-identical: {same_build}")

    # the 100k build of the main path, replayed step by step as
    # ClusterPruneIndex.build and FPFClusterer.cluster run it, with
    # synchronised host timers; it must give the same index bit for bit
    phases: dict = {}

    def phase(name, t_prev):
        torch.cuda.synchronize()
        now = time.perf_counter()
        phases[name] = phases.get(name, 0.0) + (now - t_prev)
        return now

    torch.cuda.synchronize()
    t_all = tp = time.perf_counter()
    pdocs = torch.as_tensor(docs_np).to(dev, torch.float32).contiguous()
    tp = phase("corpus to device", tp)
    pg = torch.Generator().manual_seed(0)
    clus = get_clusterer("auto", device=dev)
    m_s = fpf_sample_size(K_CLUSTERS, N_DOCS)
    fpf_each, p_reps, p_ids, p_counts = [], [], [], []
    for _ in range(T):
        tp = time.perf_counter()
        s_idx = torch.randperm(N_DOCS, generator=pg)[:m_s].to(dev)
        first = int(torch.randint(0, m_s, (1,), generator=pg))
        xs = pdocs[s_idx].contiguous()
        tp = phase("sample", tp)
        cen = uncounted("fpf_iter", lambda: fpf_centers_fused(
            xs, K_CLUSTERS, first))
        reps = pdocs[s_idx[cen.long()]]
        t_fpf = phase("fpf", tp)
        fpf_each.append(t_fpf - tp)
        a_, _ = assign_to_centers(pdocs, reps, chunk=clus.chunk)
        tp = phase("assign", t_fpf)
        for _ in range(clus.refine_iters):
            reps, _ = _medoids(pdocs, a_, K_CLUSTERS)
            tp = phase("medoids", tp)
            a_, _ = assign_to_centers(pdocs, reps, chunk=clus.chunk)
            tp = phase("reassign", tp)
        p_reps.append(reps)
        ids_, cnt_ = pack_buckets(a_.cpu().numpy(), K_CLUSTERS, N_DOCS)
        p_ids.append(ids_)
        p_counts.append(cnt_)
        tp = phase("bucket ids (host)", tp)
    bw_ = max(x_.shape[1] for x_ in p_ids)
    p_buckets = torch.as_tensor(np.stack([
        np.pad(x_, ((0, 0), (0, bw_ - x_.shape[1])), constant_values=N_DOCS)
        for x_ in p_ids]), device=dev)
    tp = phase("bucket ids (host)", tp)
    phases_total = tp - t_all
    # not part of this build (the pack is over its size for build time):
    # the first fused search makes it
    p_data, _ = pack_buckets_major(pdocs, p_buckets, N_DOCS)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - tp
    replay_same = (torch.equal(torch.stack(p_reps), index.leaders)
                   and torch.equal(p_buckets, index.buckets)
                   and np.array_equal(np.stack(p_counts),
                                      index.counts.cpu().numpy())
                   and torch.equal(p_data, index.bucket_data))
    del pdocs, p_data, xs
    log("index build split (synchronised host timers, s): "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in phases.items())
        + f"; FPF per clustering {[round(v, 4) for v in fpf_each]}; sum "
        f"{phases_total:.4f} (the counted build: {build_index_s:.4f}); "
        f"then the bucket-major pack of the first fused search {pack_s:.4f}; "
        f"same index and pack as the main path's: {replay_same}")
    print(json.dumps({"build_phases_s": phases, "fpf_per_clustering_s":
                      fpf_each, "build_replay_s": phases_total,
                      "build_s": build_index_s, "bucket_major_pack_s": pack_s}),
          flush=True)

    # any D: the kernels that stage queries, at D = 8192 (fp32 unit rows)
    wg = torch.Generator(device=dev).manual_seed(11)
    wdocs = torch.nn.functional.normalize(torch.randn(
        WIDE_DOCS, WIDE_D, device=dev, generator=wg), dim=1)
    wq = torch.nn.functional.normalize(torch.randn(
        N_QUERIES, WIDE_D, device=dev, generator=wg), dim=1)
    wperm = torch.stack([torch.randperm(WIDE_DOCS, device=dev, generator=wg)
                         for _ in range(T)])            # T clusterings
    wk, wb = 16, 320                                    # buckets, rows
    wids = torch.full((T * wk, wb), -1, dtype=torch.int32, device=dev)
    for t in range(T):
        part = wperm[t, :int(0.9 * WIDE_DOCS)].to(torch.int32)
        for c, chunk in enumerate(torch.tensor_split(part, wk)):
            wids[t * wk + c, :chunk.numel()] = chunk
    wprobes = torch.randint(0, T * wk, (N_QUERIES, 6), device=dev,
                            dtype=torch.int32, generator=wg)
    wex = wids[wprobes[:, 0].long(), 0].contiguous()
    wide_err = {}
    for pack_dtype in ("float32", "bfloat16", "int8"):
        wdata, wids_t, wsc = pack_bucket_major(
            wdocs, wids, dtype=None if pack_dtype == "float32"
            else getattr(torch, pack_dtype))
        qt_w = min(pick_query_tile(WIDE_D, wb), N_QUERIES)
        wsched, wmem = build_probe_schedule_device(
            wprobes, query_tile=qt_w,
            s_len=schedule_length(qt_w, 6, T * wk))
        wa = (wq, wdata, wids_t, wsched, wmem)
        wkw = dict(k=K, exclude=wex, scales=wsc)
        s_k, i_k = uncounted("bucket_score_tiled",
                             lambda: bucket_score_tiled(*wa, **wkw))
        s_p, i_p = bucket_score_tiled_ref(*wa, **wkw)
        err = float((s_k - s_p).abs().max())
        wide_err[f"bucket_score_tiled[{pack_dtype}]"] = err
        atol = BST_F32_ATOL if pack_dtype == "float32" else BST_Q_ATOL
        ov = overlap(i_k.cpu().numpy(), i_p.cpu().numpy())
        if err > atol or ov < BST_Q_OVERLAP:
            fail(f"bucket_score_tiled {pack_dtype} at D={WIDE_D}: err {err}, "
                 f"overlap {ov}")
        if pack_dtype == "float32":
            s_k, i_k = uncounted("bucket_score", lambda: bucket_score(
                wq, wdata, wids_t, wprobes, k=K, exclude=wex))
            s_p, i_p = bucket_score_ref(wq, wdata, wids_t, wprobes, k=K,
                                        exclude=wex)
            err = float((s_k - s_p).abs().max())
            wide_err["bucket_score"] = err
            ok = rows_without_near_ties(s_p.cpu().numpy())
            if err > V1_ATOL or not np.array_equal(i_k.cpu().numpy()[ok],
                                                   i_p.cpu().numpy()[ok]):
                fail(f"bucket_score (v1) at D={WIDE_D}: err {err}")
    s_k, i_k = uncounted("topk_score", lambda: topk_score(
        wq, wdocs, k=K + 1, exclude=wex))
    s_p, i_p = topk_score_ref(wq, wdocs, k=K + 1, exclude=wex)
    err = float((s_k - s_p).abs().max())
    wide_err["topk_score"] = err
    ok = rows_without_near_ties(s_p.cpu().numpy())
    if err > TOPK_ATOL or not np.array_equal(i_k.cpu().numpy()[ok],
                                             i_p.cpu().numpy()[ok]):
        fail(f"topk_score at D={WIDE_D}: err {err}")
    log(f"D={WIDE_D} ({WIDE_DOCS} docs, {T}x{wk} buckets of {wb} rows, "
        f"{N_QUERIES} queries x 6 probes): kernel vs plain max |err| "
        f"{wide_err}")
    del wdocs, wdata

    # ---------------------------------------- 3. kernels vs plain versions
    eng = get_engine(index, "fused")
    m = fpf_sample_size(K_CLUSTERS, N_DOCS)
    perm = torch.randperm(N_DOCS, generator=torch.Generator().manual_seed(7))
    fpf_err = 0.0
    for rows in (m, 1001, 1):
        x = index.docs[perm[:rows].to(dev)].contiguous()
        ms_k = torch.full((rows,), float("-inf"), device=dev)
        ms_p = ms_k.clone()
        cur_k = cur_p = torch.tensor(rows // 3, dtype=torch.int32, device=dev)
        for _ in range(3):                      # three chained rounds
            ms_k, cur_k, val_k = fpf_iter(x, cur_k, ms_k)
            ms_p, cur_p, val_p = fpf_iter_ref(x, cur_p, ms_p)
            err = float((ms_k - ms_p).abs().max())
            fpf_err = max(fpf_err, err)
            if err > FPF_ATOL:
                fail(f"fpf_iter maxsim differs by {err} at m={rows}")
            two = torch.sort(ms_p).values[:2].cpu().numpy()
            if int(cur_k) != int(cur_p) and (len(two) < 2 or
                                             two[1] - two[0] > FPF_ATOL):
                fail(f"fpf_iter index {int(cur_k)} != {int(cur_p)} at m={rows}")
            cur_p = cur_k                      # keep the two chains together
    log(f"fpf_iter vs plain: max |maxsim err| {fpf_err:.3g} "
        f"(m={m}, 1001, 1; D=2048)")
    # a whole FPF run (one launch) against the plain chain on the build's
    # sample size: equal centers up to the plain chain's first near tie
    x = index.docs[perm[:m].to(dev)].contiguous()
    run_k = uncounted("fpf_iter", lambda: fpf_centers_fused(x, K_CLUSTERS, 5))
    run_k2 = uncounted("fpf_iter", lambda: fpf_centers_fused(
        x, K_CLUSTERS, 5))
    ms_p = torch.full((m,), float("-inf"), device=dev)
    cur_p = torch.tensor(5, dtype=torch.int32, device=dev)
    run_same = 0
    for i in range(1, K_CLUSTERS):
        ms_p, cur_p, _ = fpf_iter_ref(x, cur_p, ms_p)
        two = torch.sort(ms_p).values[:2].cpu().numpy()
        if two[1] - two[0] <= FPF_ATOL:
            break
        if int(cur_p) != int(run_k[i]):
            fail(f"fpf_centers_fused round {i}: center {int(run_k[i])} != "
                 f"plain {int(cur_p)}")
        run_same = i
    if not torch.equal(run_k, run_k2):
        fail("two FPF runs on the card differ")
    log(f"fpf_centers_fused (one launch, {K_CLUSTERS - 1} rounds, m={m}): "
        f"centers equal the plain chain's for {run_same} rounds (up to its "
        f"first near tie, if any); two runs bit-identical")
    # the TS2 build's sample shape on rows of the TS2 fields and topic model
    # (hashed tf-idf, ~91 % zeros), which the CTAs hold compacted: three
    # chained rounds, then a whole run with each round's plain step taken
    # from the run's previous center, whose center must be the plain argmin
    # or within FPF_ATOL of it
    ts2_np, _, _ = make_corpus(CorpusConfig(
        n_docs=TS2_FPF_M, field_dims=TS2_FIELD_DIMS, n_topics=200,
        topic_mix_alpha=1.0, noise_terms=(4, 2, 24), seed=3))
    x_ts2 = torch.as_tensor(ts2_np, device=dev)
    del ts2_np
    ms_k = torch.full((TS2_FPF_M,), float("-inf"), device=dev)
    ms_p = ms_k.clone()
    cur_k = cur_p = torch.tensor(TS2_FPF_M // 3, dtype=torch.int32,
                                 device=dev)
    ts2_err = 0.0
    for r in range(3):
        ms_k, cur_k, _ = uncounted("fpf_iter",
                                   lambda: fpf_iter(x_ts2, cur_k, ms_k))
        ms_p, cur_p, _ = fpf_iter_ref(x_ts2, cur_p, ms_p)
        err = float((ms_k - ms_p).abs().max())
        gap = float(ms_p[int(cur_k)] - ms_p.min())
        ts2_err = max(ts2_err, err)
        if err > FPF_ATOL or gap > FPF_ATOL:
            fail(f"fpf_iter on the TS2-shaped sample round {r}: maxsim err "
                 f"{err}, center {int(cur_k)} {gap} above the plain minimum")
        cur_p = cur_k                          # keep the two chains together
    fpf_err = max(fpf_err, ts2_err)
    run_k = uncounted("fpf_iter", lambda: fpf_centers_fused(
        x_ts2, TS2_FPF_K, 5))
    ms_p = torch.full((TS2_FPF_M,), float("-inf"), device=dev)
    ts2_near = 0
    for i in range(1, TS2_FPF_K):
        ms_p, cur_p, _ = fpf_iter_ref(x_ts2, run_k[i - 1], ms_p)
        got, want = int(run_k[i]), int(cur_p)
        gap = float(ms_p[got] - ms_p[want]) if got != want else 0.0
        if gap > FPF_ATOL:
            fail(f"fpf_centers_fused on the TS2-shaped sample: round {i} "
                 f"center {got} is {gap} above the plain argmin {want}")
        ts2_near += got != want
    ts2_held = uncounted("fpf_iter", lambda: fpf_held_compacted(x_ts2))
    log(f"fpf_iter vs plain on a TS2-shaped sample (m={TS2_FPF_M}, "
        f"D={x_ts2.shape[1]}, {ts2_held} rows held compacted): max |maxsim "
        f"err| {ts2_err:.3g} over 3 chained rounds; a whole run's "
        f"{TS2_FPF_K - 1} rounds: {TS2_FPF_K - 1 - ts2_near} centers equal "
        f"the plain argmin, {ts2_near} within {FPF_ATOL} of it")

    bst_err = {}
    bst_inputs = {}
    # every call shape the main path made: probes=12 on each pack at the full
    # and a ragged batch, and the int8 exact tier (all buckets, 4k deep)
    cases = [(p, idx, nq, PROBES, K)
             for p, idx in (("float32", index),
                            ("bfloat16", quant["bfloat16"][0]),
                            ("int8", quant["int8"][0]))
             for nq in (N_QUERIES, RAGGED_NQ)]
    cases.append(("int8", quant["int8"][0], N_QUERIES, T * K_CLUSTERS, 4 * K))
    for pack_dtype, idx, nq, probes, k in cases:
        e = get_engine(idx, "fused")
        _, args, kw = e.kernel_inputs(qw[:nq], probes=probes, k=k,
                                      exclude=excl[:nq])
        if nq == N_QUERIES and probes == PROBES:
            bst_inputs[pack_dtype] = (args, kw)
        s_k, i_k = bucket_score_tiled(*args, **kw)
        s_p, i_p = bucket_score_tiled_ref(*args, **kw)
        torch.cuda.synchronize()
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        fin = np.isfinite(s_p)
        if not np.array_equal(fin, np.isfinite(s_k)):
            fail(f"bucket_score_tiled {pack_dtype} nq={nq}: -inf slots "
                 "differ")
        err = float(np.abs(s_k[fin] - s_p[fin]).max())
        bst_err[pack_dtype] = max(bst_err.get(pack_dtype, 0.0), err)
        if pack_dtype == "float32":
            ok = rows_without_near_ties(s_p)
            if err > BST_F32_ATOL or not np.array_equal(i_k[ok], i_p[ok]):
                fail(f"bucket_score_tiled fp32 nq={nq}: err {err}, ids "
                     f"differ on {int(np.sum(np.any(i_k != i_p, 1)))} rows")
        else:
            ov = overlap(i_k, i_p)
            if err > BST_Q_ATOL or ov < BST_Q_OVERLAP:
                fail(f"bucket_score_tiled {pack_dtype} nq={nq}: err {err}"
                     f", id overlap {ov}")
    log(f"bucket_score_tiled vs plain: max |score err| {bst_err} "
        f"(nq={N_QUERIES} and {RAGGED_NQ} at probes={PROBES}, and the int8 "
        f"exact tier at k={4 * K}; per-query exclude)")

    # topk_score on path B's inputs: the top k+1 and the bottom k over the
    # whole corpus, with exclude, and with a mask that drops 1% of rows
    mask = torch.rand(N_DOCS, device=dev, generator=torch.Generator(
        device=dev).manual_seed(3)) >= 0.01
    topk_err = 0.0
    for label, qq, kk in (("top", qw, K + 1), ("bottom", -qw, K)):
        for mk in (None, mask):
            s_k, i_k = uncounted("topk_score", lambda: topk_score(
                qq, index.docs, k=kk, exclude=excl, mask=mk))
            s_p, i_p = topk_score_ref(qq, index.docs, k=kk, exclude=excl,
                                      mask=mk)
            s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
            s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
            err = float(np.abs(s_k - s_p).max())
            topk_err = max(topk_err, err)
            ok = rows_without_near_ties(s_p)
            if err > TOPK_ATOL or not np.array_equal(i_k[ok], i_p[ok]):
                fail(f"topk_score {label} k={kk} mask={mk is not None}: err "
                     f"{err}, ids differ on "
                     f"{int(np.sum(np.any(i_k != i_p, 1)))} rows")
            if mk is not None and bool((~mask.cpu().numpy())[
                    np.where(i_k >= 0, i_k, 0)][i_k >= 0].any()):
                fail(f"topk_score {label}: a masked row came back")
    log(f"topk_score vs plain: max |score err| {topk_err:.3g} (top {K + 1} "
        f"and bottom {K} of {N_DOCS} x {int(qw.shape[1])}, exclude, with and "
        f"without a 1% row mask)")

    # bucket_score (v1) on the flat probes of the 64 requests at probes=12,
    # on the three packs (int8 unscaled: its tolerances scale with its
    # largest score, see V1_ATOL)
    flat = eng._flat_probes(qw, eng._probes_t(PROBES))
    v1_err, v1_out, v1_packs = {}, {}, {}
    for pack_dtype, idx in (("float32", index),
                            ("bfloat16", quant["bfloat16"][0]),
                            ("int8", quant["int8"][0])):
        data_v, ids_v, _ = idx.ensure_bucket_major()
        v1_packs[pack_dtype] = (data_v, ids_v)
        s_k, i_k = uncounted("bucket_score", lambda: bucket_score(
            qw, data_v, ids_v, flat, k=K + 1, exclude=excl))
        s_p, i_p = bucket_score_ref(qw, data_v, ids_v, flat, k=K + 1,
                                    exclude=excl)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        err = float(np.abs(s_k - s_p)[np.isfinite(s_p)].max())
        mag = (max(1.0, float(np.abs(s_p[np.isfinite(s_p)]).max()))
               if pack_dtype == "int8" else 1.0)
        v1_err[pack_dtype] = err
        v1_out[pack_dtype] = (s_k, i_k)
        ok = rows_without_near_ties(s_p / mag)
        if (err > V1_ATOL * mag or not np.array_equal(np.isfinite(s_k),
                                                      np.isfinite(s_p))
                or not np.array_equal(i_k[ok, :K], i_p[ok, :K])):
            fail(f"bucket_score (v1) {pack_dtype}: err {err} (tolerance "
                 f"{V1_ATOL * mag}), ids differ on "
                 f"{int(np.sum(np.any(i_k[ok] != i_p[ok], 1)))} of "
                 f"{int(ok.sum())} rows free of near ties")
    # v1 and the tiled kernel score the same candidates of the same probes
    a32, k32 = bst_inputs["float32"]
    s_t, i_t = bucket_score_tiled(*a32, **k32)
    s_t, i_t = s_t.cpu().numpy(), i_t.cpu().numpy()
    s_v, i_v = v1_out["float32"]
    ok = rows_without_near_ties(s_v)
    v1_vs_tiled = float(np.abs(s_t - s_v[:, :K]).max())
    if v1_vs_tiled > BST_F32_ATOL or not np.array_equal(i_t[ok],
                                                        i_v[ok, :K]):
        fail(f"bucket_score (v1) vs bucket_score_tiled: err {v1_vs_tiled}")
    log(f"bucket_score (v1) vs plain: max |score err| {v1_err} ({N_QUERIES} "
        f"requests x {int(flat.shape[1])} flat probes, k={K + 1}; int8 "
        f"relative to its largest |score|); vs "
        f"bucket_score_tiled: max |err| {v1_vs_tiled:.3g}, ids equal on "
        f"{int(ok.sum())}/{N_QUERIES} rows free of near ties")

    # embed_bag at the bench shape: sum, mean, weighted
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn(BENCH_V, BENCH_E, device=dev, generator=g)
    bidx = torch.randint(-1, BENCH_V, (BENCH_B, BENCH_L), device=dev,
                         dtype=torch.int32, generator=g)
    bw = torch.rand(BENCH_B, BENCH_L, device=dev, generator=g)
    eb_err = 0.0
    for label, wts, comb in (("sum", None, "sum"), ("mean", None, "mean"),
                             ("weighted", bw, "sum")):
        got = uncounted("embed_bag", lambda: embed_bag(
            table, bidx, wts, combiner=comb))
        err = float((got - embed_bag_ref(table, bidx, wts,
                                         combiner=comb)).abs().max())
        eb_err = max(eb_err, err)
        if err > EMBED_ATOL:
            fail(f"embed_bag {label}: err {err}")
    log(f"embed_bag vs plain: max |err| {eb_err:.3g} (V={BENCH_V}, "
        f"E={BENCH_E}, B={BENCH_B}, L={BENCH_L}; sum, mean, weighted)")

    # ------------------------------------------------------- 4. timing
    x = index.docs[perm[:m].to(dev)].contiguous()
    ms0 = torch.full((m,), float("-inf"), device=dev)
    cur0 = torch.tensor(5, dtype=torch.int32, device=dev)
    rounds = 64

    def plain_rounds():
        ms, cur = ms0, cur0
        for _ in range(rounds):
            ms, cur, _ = fpf_iter_ref(x, cur, ms)

    # per round as the build runs it: one launch of all K - 1 rounds
    n_rounds = K_CLUSTERS - 1
    fpf_run_ms = uncounted("fpf_iter", lambda: cuda_ms(
        lambda: fpf_centers_fused(x, K_CLUSTERS, 5), 5))
    fpf_ms = fpf_run_ms / n_rounds
    fpf_plain_ms = cuda_ms(plain_rounds, 5) / rounds
    fpf_call_ms = uncounted("fpf_iter", lambda: cuda_ms(
        lambda: fpf_iter(x, cur0, ms0), 200))
    from repro_torch.kernels.fpf_iter.ops import _plan as fpf_plan
    f_plan = fpf_plan(
        m, 2048, torch.cuda.get_device_properties(dev).multi_processor_count)
    f_grid, f_rows, f_cached = f_plan.grid, f_plan.rows, f_plan.cached
    f_held = uncounted("fpf_iter", lambda: fpf_held_compacted(x))
    if not f_held:       # the dense form holds `cached` rows of each CTA
        f_held_rows = sum(min(f_cached, m - b_ * f_rows)
                          for b_ in range(f_grid))
        f_form = f"{f_held_rows} of {m} rows held dense"
    else:
        f_form = f"{f_held} of {m} rows held compacted"
    # bounds per round: the run's least time, dense-equivalent (the sample
    # read once, 2 m D flops a round: operations bound it), the form the
    # kernel held (the dense form's: the rows not held in shared memory
    # read each round at the HBM rate, plus one read of the sample over the
    # run) and the earlier one, the sample read from HBM every round
    fpf_run_bytes = (m * 2048 + m) * 4 + K_CLUSTERS * 8
    fpf_run_flops = 2 * m * 2048 * n_rounds
    fpf_bound_ms = max(fpf_run_bytes / HBM_BYTES_PER_S,
                       fpf_run_flops / FP32_FLOPS) * 1e3 / n_rounds
    fpf_bound_by = ("bytes" if fpf_run_bytes / HBM_BYTES_PER_S
                    >= fpf_run_flops / FP32_FLOPS else "operations")
    if f_held:
        fpf_design_ms = fpf_round_bounds_ms(x, f_held, n_rounds)[1]
    else:
        fpf_design_ms = ((m - f_held_rows) * 2048 * 4 / HBM_BYTES_PER_S
                         + m * 2048 * 4 / HBM_BYTES_PER_S / n_rounds) * 1e3
    fpf_hbm_round_ms = (m * 2048 + 2 * m) * 4 / HBM_BYTES_PER_S * 1e3
    # the TS2-shaped sample, one launch of the TS2 build's rounds
    ts2_rounds = TS2_FPF_K - 1
    ts2_ms = uncounted("fpf_iter", lambda: cuda_ms(
        lambda: fpf_centers_fused(x_ts2, TS2_FPF_K, 5), 5)) / ts2_rounds
    ts2_dense_ms, ts2_held_ms = fpf_round_bounds_ms(x_ts2, ts2_held,
                                                    ts2_rounds)

    args, kw = bst_inputs["float32"]
    before = bucket_score_tiled.launches
    bst_ms = cuda_ms(lambda: bucket_score_tiled(*args, **kw), 20)
    bst_plain_ms = cuda_ms(lambda: bucket_score_tiled_ref(*args, **kw), 3)
    bucket_score_tiled.launches = before
    q32, data32, ids32, sched, member = args
    live = member.any(dim=-1)                               # (tiles, S)
    block_reads = int(live.sum())
    uniq = torch.unique(sched[live]).long()
    counts_flat = index.counts.reshape(-1)
    live_rows = int(counts_flat[uniq].sum())
    per_query_rows = int((member.sum(dim=-1).to(torch.int64)
                          * counts_flat[sched.long()]).sum())
    d = int(data32.shape[2])
    bst_bytes = (live_rows * d * 4 + uniq.numel() * b * 4
                 + q32.numel() * 4 + sched.numel() * 4 + member.numel() * 4
                 + 2 * N_QUERIES * K * 4)
    bst_flops = 2 * per_query_rows * d
    bst_bound_ms = max(bst_bytes / HBM_BYTES_PER_S,
                       bst_flops / FP32_FLOPS) * 1e3
    bst_bound_by = ("bytes" if bst_bytes / HBM_BYTES_PER_S
                    >= bst_flops / FP32_FLOPS else "operations")
    blocks_ms = block_reads * b * d * 4 / HBM_BYTES_PER_S * 1e3
    log(f"fpf_iter: one launch of {n_rounds} rounds at m={m}, D=2048 "
        f"{fpf_run_ms:.4f} ms, {fpf_ms:.5f} ms/round in the build loop "
        f"(plain {fpf_plain_ms:.4f}/round); bounds per round: the run's "
        f"{fpf_bound_ms:.6f} by {fpf_bound_by} (dense-equivalent), the "
        f"held form's {fpf_design_ms:.5f} ({f_form} on {f_grid} CTAs), the "
        f"sample from HBM every round {fpf_hbm_round_ms:.4f}; one fpf_iter() "
        f"call {fpf_call_ms:.4f} ms")
    log(f"fpf_iter on the TS2-shaped sample (m={TS2_FPF_M}, "
        f"D={x_ts2.shape[1]}, {ts2_held} rows held compacted): "
        f"{ts2_ms:.5f} ms/round over {ts2_rounds} rounds; bounds per round: "
        f"dense-equivalent {ts2_dense_ms:.6f}, the compacted form's shared "
        f"memory {ts2_held_ms:.6f} (the grid barrier not counted)")
    del x_ts2
    log(f"bucket_score_tiled fp32: {bst_ms:.3f} ms/batch (one CTA per tile: "
        f"{BST_ONE_CTA_MS['float32']} ms; plain {bst_plain_ms:.3f}, bound "
        f"{bst_bound_ms:.4f} by {bst_bound_by}: "
        f"{uniq.numel()} unique buckets, {live_rows} live rows; "
        f"{block_reads} live block reads x B x D x 4 = {blocks_ms:.4f} ms) "
        f"at nq={N_QUERIES}, QT={member.shape[-1]}, S={sched.shape[1]}")
    for pack_dtype in OVERLAP_FLOORS:
        a2, k2 = bst_inputs[pack_dtype]
        before = bucket_score_tiled.launches
        t_q = cuda_ms(lambda: bucket_score_tiled(*a2, **k2), 20)
        bucket_score_tiled.launches = before
        log(f"bucket_score_tiled {pack_dtype}: {t_q:.3f} ms/batch (one CTA "
            f"per tile: {BST_ONE_CTA_MS[pack_dtype]} ms)")
    # the exact tier's call (all T*K buckets, fp32) and calibration's (384
    # queries x every bucket: several scratch segments)
    _, ea, ekw = eng.kernel_inputs(qw, probes=T * K_CLUSTERS, k=K,
                                   exclude=excl)
    exact_call_ms = uncounted("bucket_score_tiled", lambda: cuda_ms(
        lambda: bucket_score_tiled(*ea, **ekw), 5))
    log(f"bucket_score_tiled fp32, exact tier ({T * K_CLUSTERS} buckets, "
        f"S={ea[3].shape[1]}): {exact_call_ms:.3f} ms per 64-query call, "
        f"{len(TiledCall(*ea, **ekw).segments)} segment(s)")

    # the fused batch, step by step as FusedEngine.search and the Retriever
    # run it, with CUDA events between the steps (fp32, probes=12)
    def batch_steps():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        flat = eng._flat_probes(qw, eng._probes_t(PROBES))
        ev[1].record()
        data_b, ids_b, sc_b = index.ensure_bucket_major()
        qt_b = min(pick_query_tile(d, b, k_pad=16), N_QUERIES)
        sched_b, mem_b = build_probe_schedule_device(
            flat, query_tile=qt_b,
            s_len=schedule_length(qt_b, int(flat.shape[1]),
                                  int(data_b.shape[0])))
        ev[2].record()
        call = TiledCall(qw, data_b, ids_b, sched_b, mem_b, k=K,
                         exclude=excl, scales=sc_b)
        ev[3].record()
        for seg in call.segments:
            call.score(seg)
        ev[4].record()
        for seg in call.segments:
            call.merge(seg)
        ev[5].record()
        s_b, i_b = call.result()
        i_b = torch.where(torch.isfinite(s_b), i_b, -1)
        eng._n_scored(flat)
        decompose_scores(qw, index.docs, i_b, spec)
        ev[6].record()
        torch.cuda.synchronize()
        return [ev[j].elapsed_time(ev[j + 1]) for j in range(6)]

    batch_steps()
    steps = np.median(np.array([batch_steps() for _ in range(10)]), axis=0)
    step_names = ("navigation", "schedule", "prepare (tile split, scratch)",
                  "scoring launch", "merge launch",
                  "result + n_scored + decomposition")
    split_ms = dict(zip(step_names, [float(x) for x in steps]))
    log("fused batch split (CUDA events, median of 10, ms): "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in split_ms.items())
        + f"; sum {float(steps.sum()):.4f}")

    d_full = int(index.docs.shape[1])
    topk_ms = uncounted("topk_score", lambda: cuda_ms(lambda: topk_score(
        qw, index.docs, k=K + 1, exclude=excl), 20))
    topk_plain_ms = cuda_ms(lambda: topk_score_ref(
        qw, index.docs, k=K + 1, exclude=excl), 5)
    composite_ms = cuda_ms(lambda: torch.topk(qw @ index.docs.T, K + 1), 20)
    topk_bytes = ((N_DOCS + N_QUERIES) * d_full * 4 + N_QUERIES * 4
                  + 2 * N_QUERIES * (K + 1) * 4)
    topk_flops = 2 * N_QUERIES * N_DOCS * d_full
    topk_bound_ms = max(topk_bytes / HBM_BYTES_PER_S,
                        topk_flops / FP32_FLOPS) * 1e3
    topk_bound_by = ("bytes" if topk_bytes / HBM_BYTES_PER_S
                     >= topk_flops / FP32_FLOPS else "operations")
    bench_bound_ms = 2 * 64 * 16384 * 1024 / FP32_FLOPS * 1e3
    log(f"topk_score: {topk_ms:.4f} ms per call at {N_QUERIES} x {N_DOCS} x "
        f"{d_full}, k={K + 1} (plain {topk_plain_ms:.4f}; bound "
        f"{topk_bound_ms:.4f} by {topk_bound_by}: "
        f"{topk_bytes / 1e6:.1f} MB, {topk_flops / 1e9:.2f} GFLOP); at the "
        f"bench shape 64 x 16384 x 1024: {bench['topk_score']['ms']:.4f} ms "
        f"(bound {bench_bound_ms:.4f} by operations)")
    log(f"topk_score composite yardstick (not a single library call): "
        f"torch.topk(q @ docs.T) {composite_ms:.4f} ms")

    # bucket_score (v1) on the three packs, each against its own byte bound
    # (each unique probed bucket's live rows read once); beside it the
    # reads of one pass per (query, probe), which the one-CTA-per-query
    # design made, and of one pass per group of <= 16 entries, which this
    # design makes
    p_v1 = int(flat.shape[1])
    v1_uniq, v1_entries = torch.unique(flat.reshape(-1).long(),
                                       return_counts=True)
    v1_live = int(counts_flat[v1_uniq].sum())
    v1_rows = int(counts_flat[flat.long()].sum())
    v1_group_rows = int((counts_flat[v1_uniq]
                         * -(-v1_entries // V1_GROUP)).sum())
    v1_flops = 2 * v1_rows * d
    v1_ms, v1_bound, v1_split = {}, {}, {}
    for pack_dtype, (data_v, ids_v) in v1_packs.items():
        isz = data_v.element_size()
        v1_ms[pack_dtype] = uncounted("bucket_score", lambda: cuda_ms(
            lambda: bucket_score(qw, data_v, ids_v, flat, k=K,
                                 exclude=excl), 20))
        v1_bytes = (v1_live * d * isz + v1_uniq.numel() * b * 4
                    + qw.numel() * 4 + flat.numel() * 4 + N_QUERIES * 4
                    + 2 * N_QUERIES * K * 4)
        v1_bound[pack_dtype] = (
            max(v1_bytes / HBM_BYTES_PER_S, v1_flops / FP32_FLOPS) * 1e3,
            "bytes" if v1_bytes / HBM_BYTES_PER_S >= v1_flops / FP32_FLOPS
            else "operations")

        def v1_steps():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            call = V1Call(qw, data_v, ids_v, flat, k=K, exclude=excl)
            ev[1].record()
            call.invert()
            ev[2].record()
            spans = []
            for seg in call.segments:
                for step in (call.score, call.merge):
                    step(seg)
                    ev.append(torch.cuda.Event(enable_timing=True))
                    ev[-1].record()
            torch.cuda.synchronize()
            t = [ev[j].elapsed_time(ev[j + 1]) for j in range(len(ev) - 1)]
            return [t[0], t[1], sum(t[2::2]), sum(t[3::2])]

        v1_steps()
        v1_split[pack_dtype] = dict(zip(
            ("prepare", "inversion", "scoring", "merge"),
            [float(x) for x in np.median(
                np.array([v1_steps() for _ in range(10)]), axis=0)]))
    v1_plain_ms = cuda_ms(lambda: bucket_score_ref(
        qw, data32, ids32, flat, k=K, exclude=excl), 3)
    v1_bound_ms, v1_bound_by = v1_bound["float32"]
    reads_ms = {label: rows * d * 4 / HBM_BYTES_PER_S * 1e3 for label, rows in
                (("unique", v1_live), ("per group", v1_group_rows),
                 ("per (query, probe)", v1_rows))}
    for pack_dtype in v1_packs:
        log(f"bucket_score (v1) {pack_dtype}: {v1_ms[pack_dtype]:.4f} ms/batch "
            f"(bound {v1_bound[pack_dtype][0]:.4f} by "
            f"{v1_bound[pack_dtype][1]}); split (CUDA events, median of 10, "
            f"ms): " + ", ".join(f"{k_} {v:.4f}" for k_, v in
                                 v1_split[pack_dtype].items()))
    log(f"bucket_score (v1) fp32: plain {v1_plain_ms:.3f} ms; "
        f"{N_QUERIES} x {p_v1} entries on {v1_uniq.numel()} unique buckets "
        f"(at most {int(v1_entries.max())} entries a bucket); live rows read: "
        f"unique {v1_live}, per group of <= {V1_GROUP} {v1_group_rows}, "
        f"per (query, probe) {v1_rows} (x{v1_rows / v1_live:.3f} the unique); "
        f"as fp32 at 3.35 TB/s: "
        + ", ".join(f"{k_} {v:.4f} ms" for k_, v in reads_ms.items()))

    # ------------------------------------------------- mutation path (D)
    # after the timing sections, so that they time the main path in the
    # process state it left; on a copy of the built index:
    # add 1,000 documents, 64 of them exact copies of the query documents,
    # then remove 250 old and 250 new ones; serve the 64 requests after
    # the re-pack on fused, reference and the exact tier
    import repro_torch.core.index as index_mod

    packs = []
    real_pack = index_mod.pack_buckets_major

    def counted_pack(*a, **kw):
        packs.append(1)
        return real_pack(*a, **kw)

    mut = dataclasses.replace(index)
    mret = Retriever(mut, backend="fused")
    extra_np, _, _ = make_corpus(CorpusConfig(n_docs=MUT_ADD - N_QUERIES,
                                              seed=MUT_SEED))
    adds = torch.cat([mut.docs[torch.as_tensor(qids, device=dev)],
                      torch.as_tensor(extra_np, device=dev)])
    v0, b0 = mut.version, int(mut.buckets.shape[2])
    counts0 = mut.counts.cpu().numpy()
    index_mod.pack_buckets_major = counted_pack
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_ids = mret.add(adds)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        v_add, b_add = mut.version, int(mut.buckets.shape[2])
        assign_new = mut.assign[:, N_DOCS:].copy()
        mrng = np.random.default_rng(MUT_SEED)
        old_pool = np.setdiff1d(np.arange(N_DOCS), qids)
        victims = np.sort(np.r_[
            mrng.choice(old_pool, MUT_REMOVE // 2, replace=False),
            mrng.choice(new_ids[N_QUERIES:], MUT_REMOVE // 2,
                        replace=False)])
        t0 = time.perf_counter()
        n_gone = mret.remove(victims)
        torch.cuda.synchronize()
        rm_s = time.perf_counter() - t0
        equal_w = np.full((N_QUERIES, spec.s), 1 / spec.s, np.float32)
        mut_reqs = make_requests(qids, w, spec, probes=PROBES, k=K,
                                 backend="fused")
        t0 = time.perf_counter()
        m_fused = mret.search(mut_reqs)
        m_first_s = time.perf_counter() - t0
        mret._flush_request_caches()
        t0 = time.perf_counter()
        m_fused = mret.search(mut_reqs)
        m_batch_s = time.perf_counter() - t0
        m_copy = {
            be: mret.search(make_requests(qids, equal_w, spec, probes=PROBES,
                                          k=K, backend=be))
            for be in ("fused", "reference")}
        m_copy["exact"] = mret.search(make_requests(
            qids, equal_w, spec, k=K, backend="fused", exact=True))
        m_exact = mret.search(make_requests(qids, w, spec, k=K,
                                            backend="fused", exact=True))
        live = torch.as_tensor(~mut.removed, device=dev)
        m_gt_s, m_gt_i = brute_force_topk(mut.docs, qw, K + 1, exclude=excl,
                                          mask=live)
        torch.cuda.synchronize()
        mut_launches = read_counts()
    finally:
        index_mod.pack_buckets_major = real_pack
    m_ref = mret.search(make_requests(qids, w, spec, probes=PROBES, k=K,
                                      backend="reference"))
    m_ref_k1 = get_engine(mut, "reference").search(
        qw, probes=PROBES, k=K + 1, exclude=excl)[0].cpu().numpy()
    m_gt_s, m_gt_i = m_gt_s.cpu().numpy(), m_gt_i.cpu().numpy()
    add_counts = np.zeros_like(counts0)
    np.add.at(add_counts, (np.repeat(np.arange(T), MUT_ADD),
                           assign_new.reshape(-1)), 1)
    need = int((counts0 + add_counts).max())
    want_b = b0 if need <= b0 else -(-need // 8) * 8
    copies_hit = {be: int(sum(r.hits[0].doc_id == int(nid)
                              for r, nid in zip(resps, new_ids)))
                  for be, resps in m_copy.items()}
    dirichlet_hit = int(sum(r.hits[0].doc_id == int(nid)
                            for r, nid in zip(m_fused, new_ids)))
    gone = set(victims.tolist())
    m_answers = [m_fused, m_ref, m_exact, *m_copy.values()]
    leaked = sum(len(gone & set(r.ids)) for resps in m_answers
                 for r in resps)
    leaked_gt = len(gone & set(m_gt_i.reshape(-1).tolist()))
    mf_ids = np.stack([r.doc_ids for r in m_fused])
    mr_ids = np.stack([r.doc_ids for r in m_ref])
    mf_sc = np.stack([r.scores for r in m_fused])
    mr_sc = np.stack([r.scores for r in m_ref])
    me_ids = np.stack([r.doc_ids for r in m_exact])
    me_sc = np.stack([r.scores for r in m_exact])
    m_ok = rows_without_near_ties(m_ref_k1)
    m_gt_ok = rows_without_near_ties(m_gt_s)
    log(f"mutation path launches: {mut_launches}; add {MUT_ADD} docs "
        f"{add_s * 1e3:.1f} ms (B {b0} -> {b_add}, the largest bucket "
        f"needs {need}), remove {n_gone} ({MUT_REMOVE // 2} old, "
        f"{MUT_REMOVE // 2} new) {rm_s * 1e3:.1f} ms; first fused batch "
        f"after the mutations (re-packs) {m_first_s * 1e3:.1f} ms, the "
        f"next {m_batch_s * 1e3:.1f} ms; packs made {len(packs)}; copies hit "
        f"#1 with equal weights {copies_hit}, with the main path's weights "
        f"{dirichlet_hit}/{N_QUERIES} (fused); fused == reference on "
        f"{int(m_ok.sum())}/{N_QUERIES} rows free of near ties; exact == "
        f"brute force (masked by removed) on {int(m_gt_ok.sum())}/"
        f"{N_QUERIES}; removed ids in answers {leaked}, in brute force "
        f"{leaked_gt}")
    print(json.dumps({"mutation": {
        "add_ms": add_s * 1e3, "remove_ms": rm_s * 1e3,
        "first_fused_batch_ms": m_first_s * 1e3,
        "fused_batch_ms": m_batch_s * 1e3, "b_before": b0, "b_after": b_add,
        "launches": mut_launches}}), flush=True)
    mutation_failures = []
    if (v_add, mut.version, index.version) != (v0 + 1, v0 + 2, v0):
        mutation_failures.append(
            f"versions {v0} -> {v_add} -> {mut.version} (original "
            f"{index.version}), expected one bump per mutation")
    if len(packs) != 1:
        mutation_failures.append(f"the bucket-major pack was made "
                                 f"{len(packs)} times after the mutations")
    if b_add != want_b:
        mutation_failures.append(f"B went {b0} -> {b_add}; the largest "
                                 f"bucket needs {need}, so {want_b}")
    if n_gone != MUT_REMOVE:
        mutation_failures.append(f"removed {n_gone} of {MUT_REMOVE}")
    if any(v != N_QUERIES for v in copies_hit.values()):
        mutation_failures.append(f"copies hit #1: {copies_hit}")
    if leaked or leaked_gt:
        mutation_failures.append(f"removed ids returned: {leaked} in "
                                 f"answers, {leaked_gt} in brute force")
    if not np.array_equal(mf_ids[m_ok], mr_ids[m_ok]) or not np.allclose(
            mf_sc, mr_sc, atol=SCORE_ATOL):
        mutation_failures.append("fused differs from reference after the "
                                 "mutations")
    if [r.n_scored for r in m_fused] != [r.n_scored for r in m_ref]:
        mutation_failures.append("fused n_scored differs from reference "
                                 "after the mutations")
    if not np.array_equal(me_ids[m_gt_ok], m_gt_i[m_gt_ok, :K]) or \
            not np.allclose(me_sc, m_gt_s[:, :K], atol=SCORE_ATOL):
        mutation_failures.append("exact tier differs from brute force "
                                 "after the mutations")
    # five fused engine calls (two Dirichlet batches, the equal-weight
    # batch, two exact-tier batches) and one masked brute force
    if (mut_launches["bucket_score_tiled"], mut_launches["topk_score"]) != \
            (5, 1):
        mutation_failures.append(f"mutation path launches {mut_launches}, "
                                 f"expected 5 bucket_score_tiled and 1 "
                                 f"topk_score")
    del mut, mret, adds

    # ------------------------------------------------ baselines path (E)
    # CellDec (k-means, 10 iterations, 4 regions) and PODS07 (random
    # leaders in CellDec's regions) on the same corpus; the 64 requests at
    # probes 12 through search_weighted; quality against path B's
    # topk_score ground truth. The paper's ordering is reported, not gated.
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    celldec = CellDecIndex.build(index.docs, spec, K_CLUSTERS,
                                 method="kmeans", iters=10, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    cd_build_s = time.perf_counter() - t0
    pods = CellDecIndex.build(index.docs, spec, K_CLUSTERS, method="random",
                              device=dev,
                              generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    pods_build_s = time.perf_counter() - t0 - cd_build_s
    q_docs = index.docs[torch.as_tensor(qids, device=dev)]
    w_t = torch.as_tensor(w, device=dev)
    base = {}
    for name_b, cd in (("celldec", celldec), ("pods07", pods)):
        t0 = time.perf_counter()
        s_b, i_b, n_b = cd.search_weighted(q_docs, w_t, probes=PROBES, k=K,
                                           exclude=excl)
        torch.cuda.synchronize()
        base[name_b] = (s_b, i_b, n_b, time.perf_counter() - t0)
    base_launches = read_counts()
    qual = {"ours": (torch.as_tensor(f_sc), torch.as_tensor(f_ids))}
    qual.update({nm: (v[0].cpu(), v[1].cpu()) for nm, v in base.items()})
    baseline_failures = []
    quality = {}
    for nm, (s_b, i_b) in qual.items():
        quality[nm] = (
            float(competitive_recall(i_b, gt_k).mean()),
            float(normalized_aggregate_goodness(
                s_b, torch.as_tensor(gt_s[:, :K]), far_s.cpu()).mean()))
    for nm, (s_b, i_b, n_b, _) in base.items():
        ids_b = i_b.cpu().numpy()
        if any(len(set(row)) != K or -1 in row for row in ids_b.tolist()):
            baseline_failures.append(f"{nm}: ids not distinct and valid")
        if np.any(ids_b == qids[:, None]):
            baseline_failures.append(f"{nm}: returned the excluded query")
        want_s = torch.einsum("qkd,qd->qk", index.docs[i_b.long()], qw)
        err_b = float((want_s - s_b).abs().max())
        if err_b > BASE_ATOL:
            baseline_failures.append(f"{nm}: scores differ from the exact "
                                     f"rescore by {err_b}")
        if int(n_b.min()) < K_CLUSTERS + 1 or int(n_b.max()) > N_DOCS:
            baseline_failures.append(
                f"{nm}: n_scored in [{int(n_b.min())}, {int(n_b.max())}]")
    log(f"baselines path launches: {base_launches}; builds (s): ours "
        f"{build_index_s:.3f} counted, {phases_total:.3f} replayed; celldec "
        f"(k-means, 10 iterations, 4 regions) {cd_build_s:.3f}, pods07 "
        f"{pods_build_s:.3f}; at probes={PROBES} CR@{K} / NAG: "
        + ", ".join(f"{nm} {c:.3f} / {g:.4f}" for nm, (c, g)
                    in quality.items())
        + "; search ms per batch: "
        + ", ".join(f"{nm} {v[3] * 1e3:.1f}" for nm, v in base.items())
        + f"; mean n_scored: ours {np.mean([r.n_scored for r in fused]):.0f}"
        + "".join(f", {nm} {float(v[2].float().mean()):.0f}"
                  for nm, v in base.items()))
    print(json.dumps({"baselines": {
        "build_s": {"ours_counted": build_index_s, "ours_replay":
                    phases_total, "celldec": cd_build_s,
                    "pods07": pods_build_s},
        "cr_nag": quality, "launches": base_launches}}), flush=True)
    del celldec, pods, base

    # -------------------------------------------------- serving path (F)
    # the async tier (repro_torch.serving) on a copy of the 100k index
    # without its pack (the ladder kept): a burst of the load test's mix on
    # two replicas, each on its own CUDA stream, must pack once and answer
    # as one-by-one sync search; counts at 0 around the burst and the sync
    # checks. Then the load test's loops (not counted) and two chaos
    # profiles held to the load test's checks.
    import asyncio

    from repro_torch.benchmarks import loadtest
    from repro_torch.serving import SearchServer

    fidx = dataclasses.replace(index, bucket_data=None, bucket_scales=None)
    mix = loadtest.make_mix(N_DOCS, spec, F_REQUESTS, seed=0)

    async def burst():
        async with SearchServer(Retriever(fidx, backend="fused"),
                                window_s=F_WINDOW_S, replicas=2,
                                max_queue_depth=F_REQUESTS) as server:
            streams = [e.stream for e in server.pool.entries]
            resps = await asyncio.gather(
                *(server.submit(r) for r in mix), return_exceptions=True)
            return (resps, streams, server.stats.snapshot(),
                    server.pool.health_snapshot())

    packs.clear()
    index_mod.pack_buckets_major = counted_pack
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_resps, f_streams, f_stats, f_health = asyncio.run(burst())
        f_burst_s = time.perf_counter() - t0
        solo = Retriever(fidx, backend="fused")
        t0 = time.perf_counter()
        f_sync = [solo.search(r) for r in mix]
        f_sync_s = time.perf_counter() - t0
        # k + 1 deep, one call per shape: which rows hold near ties
        f_clear = loadtest.clear_rows(solo, mix, f_sync)
        f_sync_calls = len(mix) + len({(r.k, r.probes) for r in mix})
        torch.cuda.synchronize()
        serve_launches = read_counts()
    finally:
        index_mod.pack_buckets_major = real_pack
    serving_failures = []
    f_ok = [r for r in f_resps if not isinstance(r, Exception)]
    if len(f_ok) != len(mix) or f_stats["completed"] != len(mix):
        serving_failures.append(
            f"{len(mix) - len(f_ok)} of {len(mix)} burst requests failed: "
            f"{[r for r in f_resps if isinstance(r, Exception)][:3]}")
    f_bad = sum(
        1 for got, want, ok in zip(f_resps, f_sync, f_clear)
        if ok and not isinstance(got, Exception) and (
            got.degraded or got.n_scored != want.n_scored
            or not np.array_equal(got.doc_ids, want.doc_ids)
            or not np.allclose(got.scores, want.scores, rtol=1e-5,
                               atol=1e-6)))
    if f_bad or f_clear.mean() < 0.5:
        serving_failures.append(
            f"burst answers differ from one-by-one sync search on {f_bad} "
            f"of {int(f_clear.sum())} rows free of near ties (of "
            f"{len(mix)})")
    if len(packs) != 1:
        serving_failures.append(f"the burst made the pack {len(packs)} "
                                f"times, expected once")
    if (len({id(x) for x in f_streams}) != 2
            or any(not isinstance(x, torch.cuda.Stream) for x in f_streams)
            or torch.cuda.default_stream(dev) in f_streams):
        serving_failures.append(f"replica streams {f_streams} are not two "
                                f"side streams")
    if any(h["successes"] < 1 for h in f_health):
        serving_failures.append(f"a replica served nothing: {f_health}")
    f_attempts = f_stats["batches"] + f_stats["retries"] + f_stats["hedges"]
    if (f_stats["degraded"] or f_stats["failed"]
            or f_stats["budget_exhausted"]):
        serving_failures.append(f"the fault-free burst degraded or failed: "
                                f"{f_stats}")
    if serve_launches["bucket_score_tiled"] != f_attempts + f_sync_calls:
        serving_failures.append(
            f"bucket_score_tiled launched {serve_launches['bucket_score_tiled']}"
            f" times for {f_stats['batches']} dispatched batches + "
            f"{f_stats['retries']} retries + {f_stats['hedges']} hedges + "
            f"{f_sync_calls} sync checks")
    log(f"serving path launches: {serve_launches}; burst of {len(mix)} on 2 "
        f"replicas {f_burst_s * 1e3:.1f} ms ({f_stats['batches']} batches, "
        f"mean {f_stats['mean_batch_size']}, retries {f_stats['retries']}, "
        f"hedges {f_stats['hedges']}, wait p50/p99 "
        f"{f_stats['queue_wait_ms']['p50']}/{f_stats['queue_wait_ms']['p99']}"
        f" ms, compute p50/p99 {f_stats['compute_ms']['p50']}/"
        f"{f_stats['compute_ms']['p99']} ms); one-by-one sync "
        f"{f_sync_s:.2f} s; packs {len(packs)}; ids, n_scored and scores "
        f"equal on {int(f_clear.sum()) - f_bad}/{int(f_clear.sum())} rows "
        f"free of near ties (of {len(mix)})")
    log(f"serving path replicas: {f_health}")

    # throughput: the sequential baseline on a fresh facade, the closed loop
    # (64 workers) on 1 and 2 replicas, the open loop at half of the
    # 2-replica closed-loop QPS
    base_f = Retriever(fidx, backend="fused")
    for r in {(r.k, r.probes): r for r in mix}.values():
        base_f.search(r)
    base_f._flush_request_caches()
    f_seq = loadtest.sequential_baseline(base_f, mix)
    f_loops = [f_seq]
    log(f"serving path sequential: {f_seq['qps']:.1f} QPS, p50/p99 "
        f"{f_seq['p50_ms']:.2f}/{f_seq['p99_ms']:.2f} ms")
    for reps in (1, 2):
        f_loops += asyncio.run(loadtest.serve_loops(
            Retriever(fidx, backend="fused"), mix, concurrency=64,
            window_s=F_WINDOW_S, replicas=reps, modes=("closed",)))
    qps2 = f_loops[-2]["qps"]
    f_loops += asyncio.run(loadtest.serve_loops(
        Retriever(fidx, backend="fused"), mix, rate_qps=0.5 * qps2,
        window_s=F_WINDOW_S, replicas=2, modes=("open",)))
    for e in f_loops[1:]:
        log("serving path " + loadtest.format_entry(e))
    for e in f_loops:
        if e["mode"] in ("closed", "open") and e["completed"] != len(mix):
            serving_failures.append(f"{e['mode']} loop completed "
                                    f"{e['completed']} of {len(mix)}")

    # chaos: the fault-free pass, then each profile through a fresh
    # fault-injected 4-replica server, held to the load test's checks; at
    # least F_CHAOS_SECONDS of requests at the closed loop's rate
    n_chaos = int(min(N_DOCS, max(F_REQUESTS, F_CHAOS_SECONDS * qps2)))
    n_chaos = -(-n_chaos // 16) * 16
    t0 = time.perf_counter()
    try:
        f_chaos = loadtest.chaos_suite(
            Retriever(fidx, backend="fused"),
            loadtest.chaos_mix(N_DOCS, spec, n_chaos, seed=0),
            seed=0, window_s=F_WINDOW_S, profiles=F_CHAOS_PROFILES)
    except SystemExit as e:
        f_chaos = []
        serving_failures.append(f"chaos: {e}")
    log(f"serving path chaos ({', '.join(F_CHAOS_PROFILES)}), {n_chaos} "
        f"requests each, in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"serving": {
        "burst": {"requests": len(mix), "ms": f_burst_s * 1e3, **f_stats},
        "launches": serve_launches, "loops": f_loops,
        "chaos": f_chaos}}, default=str), flush=True)
    del fidx, base_f, solo

    # -------------------------------------------------- sharded path (G)
    # the sharded backend (repro_torch.core.distributed, ShardedEngine) on
    # copies of the 100k index without the fused pack, G_SHARDS shards on
    # the one card. Counts at 0 around the sharded searches and the sharded
    # brute force; fused (path A's index) and path B's ground truth are the
    # yardsticks. Then the kernel against its plain version at the
    # shard-local shape, a serving burst, 1,000 adds and 500 removes under
    # a held engine, the timings at S = 1, 2, 4, 8 (each pack built and
    # dropped in turn), the throughput bench, and shards on distinct cards
    # where there are several.
    import gc

    import repro_torch.core.distributed as dist_mod
    from repro_torch.benchmarks import throughput
    from repro_torch.core.distributed import (
        build_local_buckets, distributed_brute_topk, local_exclude,
        merge_topk, shard_docs, shard_rows)

    v1_packs.clear()
    bst_inputs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    sharded_failures = []
    g_opts = {"n_shards": G_SHARDS}
    # the pack's bytes, reckoned on the host before it is built
    n_loc = shard_rows(N_DOCS, G_SHARDS)
    b_l = int(build_local_buckets(
        np.pad(index.assignments(), ((0, 0), (0, n_loc * G_SHARDS - N_DOCS)),
               constant_values=-1),
        n_loc * G_SHARDS, G_SHARDS, K_CLUSTERS).shape[-1])
    g_bytes = {pd: G_SHARDS * T * K_CLUSTERS * b_l * d_full * isz
               for pd, isz in (("float32", 4), ("bfloat16", 2), ("int8", 1))}
    free0, total0 = torch.cuda.mem_get_info(dev)
    log(f"sharded path: S={G_SHARDS}, n_local={n_loc}, B_l={b_l} (global "
        f"B {b}); shard packs "
        + ", ".join(f"{pd} {v / 1e9:.2f} GB" for pd, v in g_bytes.items())
        + f" (the fused fp32 pack {pack_bytes / 1e9:.2f} GB); card free "
        f"{free0 / 1e9:.1f} of {total0 / 1e9:.1f} GB")
    gidx = {pd: dataclasses.replace(
        index, bucket_data=None, bucket_scales=None,
        pack_dtype=None if pd == "float32" else pd) for pd in g_bytes}
    g_pack_s = {}
    for pd, gi in gidx.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_data = gi.ensure_local_bucket_major(G_SHARDS)[0]
        torch.cuda.synchronize()
        g_pack_s[pd] = time.perf_counter() - t0
        got_bytes = g_data.numel() * g_data.element_size()
        if (tuple(g_data.shape) != (G_SHARDS, T * K_CLUSTERS, b_l, d_full)
                or got_bytes != g_bytes[pd]):
            sharded_failures.append(
                f"{pd} shard pack {tuple(g_data.shape)}, {got_bytes} bytes; "
                f"reckoned {g_bytes[pd]}")
    del g_data
    log("sharded packs built (s): "
        + ", ".join(f"{pd} {v:.4f}" for pd, v in g_pack_s.items())
        + f"; card free {torch.cuda.mem_get_info(dev)[0] / 1e9:.1f} GB")

    g_ret = Retriever(gidx["float32"], backend="sharded", engine_opts=g_opts)
    g_eng = {pd: get_engine(gi, "sharded", **g_opts)
             for pd, gi in gidx.items()}
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_resp = g_ret.search(make_requests(qids, w, spec, probes=PROBES, k=K,
                                        backend="sharded"))
    g_batch_s = time.perf_counter() - t0
    g_searches = 1
    g_plain = g_eng["float32"].search(qw, probes=PROBES, k=K)
    g_q = {pd: g_eng[pd].search(qw, probes=PROBES, k=K, exclude=excl)
           for pd in ("bfloat16", "int8")}
    g_resc = {pd: e.search(qw, probes=PROBES, k=K, exclude=excl,
                           rescore=G_RESCORE) for pd, e in g_eng.items()}
    g_exact = {pd: g_eng[pd].search_exact(qw, k=K, exclude=excl)
               for pd in ("float32", "int8")}
    g_searches += 1 + len(g_q) + len(g_resc) + len(g_exact)
    g_brute = distributed_brute_topk(
        shard_docs(gidx["float32"].docs, G_SHARDS), qw, k=K + 1,
        exclude=excl, n_valid=N_DOCS)
    torch.cuda.synchronize()
    g_launches = read_counts()
    log(f"sharded path launches: {g_launches} ({g_searches} sharded "
        f"searches x {G_SHARDS} shards, 1 sharded brute force); 64-request "
        f"sharded batch {g_batch_s * 1e3:.1f} ms host wall")
    if (g_launches["bucket_score_tiled"] != G_SHARDS * g_searches
            or g_launches["topk_score"] != G_SHARDS
            or any(g_launches[n_] for n_ in ("fpf_iter", "bucket_score",
                                             "embed_bag"))):
        sharded_failures.append(
            f"launches {g_launches}, expected {G_SHARDS * g_searches} "
            f"bucket_score_tiled and {G_SHARDS} topk_score")

    # yardsticks, outside the count: fused on path A's index and packs
    f_eng = get_engine(index, "fused")
    f_plain, f_plain_k1 = (f_eng.search(qw, probes=PROBES, k=kk)
                           for kk in (K, K + 1))
    f_resc = {pd: get_engine(ix, "fused").search(
        qw, probes=PROBES, k=K, exclude=excl, rescore=G_RESCORE)
        for pd, ix in (("float32", index), ("bfloat16", quant["bfloat16"][0]),
                       ("int8", quant["int8"][0]))}
    g_rows = rows_without_near_ties(ref_k1)
    g_gt_rows = rows_without_near_ties(gt_s)

    def np3(res):
        return [x.cpu().numpy() for x in res]

    g_cmp = {}

    def same_as(tag, got, want, rows, atol=SHARD_ATOL, all_rows=True):
        """ids equal on ``rows``, scores within ``atol`` on every row (on
        ``rows`` only with ``all_rows=False``: where two quantised packs
        may surface different candidates, as the rescore tails do on rows
        with near ties), n_scored equal when both carry it; records the
        largest difference and whether the scores are bit-equal."""
        diff = np.abs(got[0] - want[0])
        err = float((diff if all_rows else diff[rows]).max())
        g_cmp[tag] = {"max_abs_diff": float(diff.max()),
                      "max_abs_diff_gated": err,
                      "bit_equal": bool(np.array_equal(got[0], want[0])),
                      "rows": int(rows.sum())}
        if not np.array_equal(got[1][rows], want[1][rows]) or err > atol:
            sharded_failures.append(
                f"{tag}: ids differ on {int(np.any(got[1] != want[1], 1)[rows].sum())}"
                f" of {int(rows.sum())} clear rows, max |score diff| {err}")
        if len(got) > 2 and len(want) > 2 and not np.array_equal(got[2],
                                                                 want[2]):
            sharded_failures.append(f"{tag}: n_scored differs")

    g_ids = np.stack([r.doc_ids for r in g_resp])
    g_sc = np.stack([r.scores for r in g_resp])
    g_n = np.asarray([r.n_scored for r in g_resp])
    same_as("fp32 Retriever (exclude) vs fused", (g_sc, g_ids, g_n),
            (f_sc, f_ids, np.asarray([r.n_scored for r in fused])), g_rows)
    same_as("fp32 plain vs fused", np3(g_plain), np3(f_plain),
            rows_without_near_ties(f_plain_k1[0].cpu().numpy()))
    same_as("fp32 rescore vs fused", np3(g_resc["float32"]),
            np3(f_resc["float32"]), g_rows)
    for pd in ("float32", "int8"):
        e_ = np3(g_exact[pd])
        same_as(f"{pd} exact tier vs topk_score", e_[:2],
                (gt_s[:, :K], gt_i[:, :K]), g_gt_rows, atol=SCORE_ATOL)
    g_overlap = {}
    for pd in ("bfloat16", "int8"):
        q_ = np3(g_q[pd])
        g_overlap[pd] = overlap(q_[1], g_ids)
        if not np.array_equal(q_[2], g_n) or g_overlap[pd] < G_OVERLAP:
            sharded_failures.append(
                f"{pd}: n_scored equal to fp32 {np.array_equal(q_[2], g_n)}"
                f", overlap with fp32 {g_overlap[pd]} (floor {G_OVERLAP})")
        same_as(f"{pd} rescore vs fused {pd} rescore", np3(g_resc[pd]),
                np3(f_resc[pd]), g_rows, all_rows=False)
    gb = np3(g_brute)
    same_as("brute force, 4 shards vs topk_score", gb, (gt_s, gt_i),
            g_gt_rows, atol=TOPK_ATOL)
    log(f"sharded vs yardsticks (clear rows, max |score diff|, bit-equal): "
        + "; ".join(f"{k_}: {v['rows']} rows, {v['max_abs_diff']:.3g}, "
                    f"{v['bit_equal']}" for k_, v in g_cmp.items())
        + f"; overlap with fp32 {g_overlap}")

    # the kernel against its plain version at the shard-local shape, each
    # shard, on the three packs (not counted)
    g_kerr = {}
    for pd, e in g_eng.items():
        _, args_g, kw_g = e.kernel_inputs(qw, probes=PROBES, k=K,
                                          exclude=excl)
        data_g, ids_g, sc_g, q_g, sched_g, mem_g = args_g
        for s in range(G_SHARDS):
            sargs = (q_g, data_g[s], ids_g[s], sched_g, mem_g)
            skw = dict(k=K, exclude=local_exclude(excl, s * n_loc, n_loc),
                       scales=None if sc_g is None else sc_g[s])
            s_k, i_k = np3(uncounted("bucket_score_tiled",
                                     lambda: bucket_score_tiled(*sargs,
                                                                **skw)))
            s_p, i_p = np3(bucket_score_tiled_ref(*sargs, **skw))
            fin = np.isfinite(s_p)
            err = float(np.abs(s_k[fin] - s_p[fin]).max())
            g_kerr[pd] = max(g_kerr.get(pd, 0.0), err)
            ok = rows_without_near_ties(s_p)
            bad = (not np.array_equal(fin, np.isfinite(s_k))
                   or (err > BST_F32_ATOL
                       or not np.array_equal(i_k[ok], i_p[ok])
                       if pd == "float32" else
                       err > BST_Q_ATOL or overlap(i_k, i_p) < BST_Q_OVERLAP))
            if bad:
                sharded_failures.append(
                    f"bucket_score_tiled {pd} shard {s} (B_l={b_l}) vs plain:"
                    f" err {err}")
    # one shard's fp32 call at the shard-local shape: its time (20 back to
    # back) and its bound (the shard's live rows of the unique scheduled
    # buckets read once, its ids, the queries, schedule and membership,
    # the lists written; 2 D flops per (query, live row) it scores)
    _, args_g, kw_g = g_eng["float32"].kernel_inputs(qw, probes=PROBES, k=K,
                                                     exclude=excl)
    data_g, ids_g, _, q_g, sched_g, mem_g = args_g
    sargs = (q_g, data_g[0], ids_g[0], sched_g, mem_g)
    skw = dict(k=K, exclude=local_exclude(excl, 0, n_loc))
    g_shard_ms = uncounted("bucket_score_tiled", lambda: cuda_ms(
        lambda: bucket_score_tiled(*sargs, **skw), 20))
    live_g = mem_g.any(dim=-1)
    uniq_g = torch.unique(sched_g[live_g]).long()
    counts_g = (ids_g[0] >= 0).sum(dim=-1)                  # (T*K,)
    rows_g = int(counts_g[uniq_g].sum())
    pq_rows_g = int((mem_g.sum(dim=-1).to(torch.int64)
                     * counts_g[sched_g.long()]).sum())
    g_sh_bytes = (rows_g * d_full * 4 + uniq_g.numel() * b_l * 4
                  + q_g.numel() * 4 + sched_g.numel() * 4 + mem_g.numel() * 4
                  + 2 * N_QUERIES * K * 4)
    g_sh_flops = 2 * pq_rows_g * d_full
    g_shard_bound = max(g_sh_bytes / HBM_BYTES_PER_S,
                        g_sh_flops / FP32_FLOPS) * 1e3
    g_shard_by = ("bytes" if g_sh_bytes / HBM_BYTES_PER_S
                  >= g_sh_flops / FP32_FLOPS else "operations")
    del args_g, data_g, ids_g, sargs
    log(f"bucket_score_tiled vs plain at the shard-local shape (B_l={b_l}, "
        f"each of {G_SHARDS} shards): max |score err| {g_kerr}; shard 0's "
        f"fp32 call {g_shard_ms:.4f} ms (bound {g_shard_bound:.4f} by "
        f"{g_shard_by}: {uniq_g.numel()} unique buckets, {rows_g} live "
        f"rows of the shard)")

    # more than one card: one search with the shards on distinct cards
    n_cards = torch.cuda.device_count()
    g_multi = None
    if n_cards > 1:
        mc = ShardedEngine(gidx["float32"], n_shards=n_cards,
                           devices=tuple(f"cuda:{i}" for i in range(n_cards)))
        got = np3(mc.search(qw, probes=PROBES, k=K, exclude=excl))
        same_as(f"{n_cards} cards vs fused", got,
                (f_sc, f_ids, np.asarray([r.n_scored for r in fused])),
                g_rows)
        g_multi = g_cmp[f"{n_cards} cards vs fused"]
        del mc
    else:
        log("sharded path: shards on distinct cards NOT run (this machine "
            "has one card; the shards above share it)")

    # serving: a burst of the load test's mix through SearchServer on the
    # sharded backend, against one-by-one sync search
    g_mix = loadtest.make_mix(N_DOCS, spec, G_REQUESTS, seed=1)

    async def g_burst():
        async with SearchServer(
                Retriever(gidx["float32"], backend="sharded",
                          engine_opts=g_opts),
                window_s=F_WINDOW_S, replicas=2,
                max_queue_depth=G_REQUESTS) as server:
            resps = await asyncio.gather(
                *(server.submit(r) for r in g_mix), return_exceptions=True)
            return resps, server.stats.snapshot()

    t0 = time.perf_counter()
    g_sresps, g_sstats = asyncio.run(g_burst())
    g_burst_s = time.perf_counter() - t0
    g_solo = Retriever(gidx["float32"], backend="sharded", engine_opts=g_opts)
    g_sync = [g_solo.search(r) for r in g_mix]
    g_clear = loadtest.clear_rows(g_solo, g_mix, g_sync)
    g_sbad = sum(
        1 for got, want, ok in zip(g_sresps, g_sync, g_clear)
        if isinstance(got, Exception) or (ok and (
            got.degraded or got.n_scored != want.n_scored
            or not np.array_equal(got.doc_ids, want.doc_ids)
            or not np.allclose(got.scores, want.scores, rtol=1e-5,
                               atol=1e-6))))
    if g_sbad or g_clear.mean() < 0.5 or g_sstats["completed"] != G_REQUESTS:
        sharded_failures.append(
            f"serving burst: {g_sbad} answers differ from sync search on "
            f"{int(g_clear.sum())} clear rows; {g_sstats['completed']} of "
            f"{G_REQUESTS} completed")
    log(f"sharded serving burst: {G_REQUESTS} requests on 2 replicas in "
        f"{g_burst_s * 1e3:.1f} ms ({g_sstats['batches']} batches); equal to "
        f"one-by-one sync search on {int(g_clear.sum()) - g_sbad}/"
        f"{int(g_clear.sum())} clear rows")
    del g_solo, g_sync, g_sresps

    # mutations under a held engine: 1,000 adds (path D's) and 500 removes,
    # then the same engine object repacks once and equals reference
    for pd in ("bfloat16", "int8"):
        gidx.pop(pd)
        g_eng.pop(pd)
        quant[pd] = (None, quant[pd][1])
    g_q = g_resc = g_exact = f_resc = None
    gc.collect()
    torch.cuda.empty_cache()
    m_idx, m_eng = gidx["float32"], g_eng["float32"]
    g_packs = []
    real_local_pack = dist_mod.pack_local_bucket_major

    def counted_local_pack(*a, **kw):
        g_packs.append(1)
        return real_local_pack(*a, **kw)

    dist_mod.pack_local_bucket_major = counted_local_pack
    try:
        m_new = m_idx.add_documents(torch.cat([
            m_idx.docs[torch.as_tensor(qids, device=dev)],
            torch.as_tensor(extra_np, device=dev)]))
        m_idx.remove_documents(victims)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm = np3(m_eng.search(qw, probes=PROBES, k=K, exclude=excl))
        gm_first_s = time.perf_counter() - t0
        gm2 = np3(m_eng.search(qw, probes=PROBES, k=K, exclude=excl))
    finally:
        dist_mod.pack_local_bucket_major = real_local_pack
    gm_ref = np3(get_engine(m_idx, "reference").search(
        qw, probes=PROBES, k=K + 1, exclude=excl))
    same_as("after the mutations vs reference", gm,
            (gm_ref[0][:, :K], gm_ref[1][:, :K], gm_ref[2]),
            rows_without_near_ties(gm_ref[0]), atol=SCORE_ATOL)
    if len(g_packs) != 1 or not np.array_equal(gm[1], gm2[1]):
        sharded_failures.append(f"the held engine repacked {len(g_packs)} "
                                f"times after the mutations, expected once")
    if set(victims.tolist()) & set(gm[1].reshape(-1).tolist()):
        sharded_failures.append("a removed id came back after the mutations")
    log(f"sharded after {MUT_ADD} adds and {MUT_REMOVE} removes: the held "
        f"engine repacked {len(g_packs)} time(s), first search "
        f"{gm_first_s * 1e3:.1f} ms (repack included); ids {len(m_new)} "
        f"added")
    del m_idx, m_eng, g_ret, g_eng, gidx
    gc.collect()
    torch.cuda.empty_cache()

    # timing: CUDA events, median of 10 per 64-query fp32 batch; fused,
    # then the sharded engine at each S on a copy of path A's index, its
    # pack built and dropped in turn, each shard's scoring and merge
    # launches and the cross-shard merge split out
    def shard_split(e):
        _, args_s, kw_s = e.kernel_inputs(qw, probes=PROBES, k=K,
                                          exclude=excl)
        data_s, ids_s, sc_s, q_s, sched_s, mem_s = args_s
        nl = kw_s["n_local"]
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 * e.n_shards + 2)]
        ev[0].record()
        parts = []
        for s in range(e.n_shards):
            call = TiledCall(q_s, data_s[s], ids_s[s], sched_s, mem_s, k=K,
                             exclude=local_exclude(excl, s * nl, nl),
                             scales=None if sc_s is None else sc_s[s])
            for seg in call.segments:
                call.score(seg)
            ev[2 * s + 1].record()
            for seg in call.segments:
                call.merge(seg)
            ev[2 * s + 2].record()
            sc_, li_ = call.result()
            parts.append((sc_, torch.where(li_ >= 0, li_ + s * nl, -1)))
        merge_topk(torch.stack([p[0] for p in parts], 1),
                   torch.stack([p[1] for p in parts], 1), K)
        ev[-1].record()
        torch.cuda.synchronize()
        t_ = [ev[j].elapsed_time(ev[j + 1]) for j in range(len(ev) - 1)]
        return [sum(t_[0:-1:2]), sum(t_[1:-1:2]), t_[-1]]

    g_time = {"fused": uncounted("bucket_score_tiled", lambda: events_ms(
        lambda: f_eng.search(qw, probes=PROBES, k=K, exclude=excl)))}
    # the scoring call alone, back to back (20 calls): fused's one
    # bucket_score_tiled, the sharded engine's distributed_bucket_score
    _, fa, fkw = f_eng.kernel_inputs(qw, probes=PROBES, k=K, exclude=excl)
    g_call_ms = {"fused": uncounted("bucket_score_tiled", lambda: cuda_ms(
        lambda: bucket_score_tiled(*fa, **fkw), 20))}
    del fa, fkw
    g_split, g_bpq, g_tpack_s, g_tb_l = {}, {}, {}, {}
    tidx = dataclasses.replace(index, bucket_data=None, bucket_scales=None)
    for s_n in G_TIMING_SHARDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_data = tidx.ensure_local_bucket_major(s_n)[0]
        torch.cuda.synchronize()
        g_tpack_s[s_n] = time.perf_counter() - t0
        g_tb_l[s_n] = int(t_data.shape[2])
        del t_data
        e = get_engine(tidx, "sharded", n_shards=s_n)
        g_time[f"S={s_n}"] = uncounted("bucket_score_tiled", lambda: events_ms(
            lambda: e.search(qw, probes=PROBES, k=K, exclude=excl)))
        _, sa, skw_ = e.kernel_inputs(qw, probes=PROBES, k=K, exclude=excl)
        g_call_ms[f"S={s_n}"] = uncounted("bucket_score_tiled", lambda: cuda_ms(
            lambda: dist_mod.distributed_bucket_score(*sa, **skw_), 20))
        del sa, skw_
        uncounted("bucket_score_tiled", lambda: shard_split(e))
        g_split[s_n] = dict(zip(
            ("prepare + scoring launches", "merge launches",
             "cross-shard merge"),
            [float(x) for x in np.median(np.array([
                uncounted("bucket_score_tiled", lambda: shard_split(e))
                for _ in range(10)]), axis=0)]))
        g_bpq[s_n] = throughput._sharded_pack_stats(e, qw, PROBES, K)[0]
        del e
        tidx.__dict__.pop("_engines", None)
        tidx.__dict__.pop("_local_bucket_major", None)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"sharded timing (CUDA events, median of 10, ms per 64-query fp32 "
        f"engine call): " + ", ".join(f"{k_} {v:.4f}"
                                      for k_, v in g_time.items())
        + "; the scoring call alone (20 back to back, ms): "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in g_call_ms.items()))
    for s_n in G_TIMING_SHARDS:
        log(f"sharded S={s_n}: B_l {g_tb_l[s_n]}, pack "
            f"{g_tpack_s[s_n]:.4f} s, packed bytes per query "
            f"{g_bpq[s_n]:.1f}; launches split (median of 10, ms): "
            + ", ".join(f"{k_} {v:.4f}" for k_, v in g_split[s_n].items()))
    del tidx
    gc.collect()
    torch.cuda.empty_cache()

    # the throughput bench at quick scale (its byte-ratio gate raises)
    t0 = time.perf_counter()
    g_tp = throughput.run("quick", 0, n_shards=G_SHARDS, device=dev)
    log(f"throughput.run quick (n_shards={G_SHARDS}) in "
        f"{time.perf_counter() - t0:.1f} s: {len(g_tp)} entries, byte ratios "
        f"gated")
    print(json.dumps({"sharded": {
        "n_shards": G_SHARDS, "n_local": n_loc, "b_l": b_l, "b": b,
        "pack_bytes": g_bytes, "pack_s": g_pack_s, "launches": g_launches,
        "searches": g_searches, "batch_host_ms": g_batch_s * 1e3,
        "compare": g_cmp, "overlap_with_fp32": g_overlap,
        "kernel_vs_plain_err": g_kerr, "multi_card": g_multi,
        "serving": {"requests": G_REQUESTS, "ms": g_burst_s * 1e3,
                    "clear_rows": int(g_clear.sum()), "mismatches": g_sbad,
                    **g_sstats},
        "mutation": {"repacks": len(g_packs),
                     "first_search_ms": gm_first_s * 1e3},
        "shard_call_ms": g_shard_ms, "shard_call_bound_ms": g_shard_bound,
        "shard_call_bound_by": g_shard_by, "scoring_call_ms": g_call_ms,
        "timing_ms": g_time, "split_ms": g_split, "b_l_by_s": g_tb_l,
        "pack_s_by_s": g_tpack_s, "packed_bytes_per_query": g_bpq,
        "throughput": g_tp}}, default=str), flush=True)

    # --------------------------------------------------------- 5. gates
    # the build: one launch per clustering, running all its rounds
    if launches["fpf_iter"] != T or fpf_rounds < T * (K_CLUSTERS - 1):
        fail(f"fpf_iter launched {launches['fpf_iter']} times for "
             f"{fpf_rounds} rounds on the main path, expected {T} launches "
             f"and >= {T * (K_CLUSTERS - 1)} rounds")
    if launches["bucket_score_tiled"] < fused_calls:
        fail(f"bucket_score_tiled launched {launches['bucket_score_tiled']} "
             f"times for {fused_calls} fused engine calls")
    # quality path (B): every brute-force call on the card launched
    # topk_score; the calibration sweeps launched bucket_score_tiled
    if quality_launches["topk_score"] < brute_calls:
        fail(f"topk_score launched {quality_launches['topk_score']} times "
             f"for {brute_calls} brute-force calls on the quality path")
    if quality_tc:
        fail(f"the fp32 brute force took the bf16 tensor-core core "
             f"{quality_tc} times")
    if calib_launches["bucket_score_tiled"] < len(ladder.probes) + 1:
        fail(f"calibration launched bucket_score_tiled "
             f"{calib_launches['bucket_score_tiled']} times for "
             f"{len(ladder.probes)} sweep levels and the exact tier")
    for name in ("bucket_score", "embed_bag", "topk_score",
                 "bucket_score_tiled", "fpf_iter"):
        if bench_launches[name] < 1:
            fail(f"the kernels bench never launched {name}")
    bad = [r["kernel"] for r in bench_rows if not r["agrees"]]
    if bad:
        fail(f"kernels bench: kernel and plain version disagree on {bad}")
    for target, (planned, floored, _, _) in served.items():
        for label, resps in (("recall_target", planned),
                             ("min_recall", floored)):
            got = achieved(resps)
            if got < target - RECALL_SLACK:
                fail(f"{label}={target}: achieved recall {got:.4f} below "
                     f"{target - RECALL_SLACK}")
        plan_p = ladder.plan(target)
        want_pred = ladder.predicted_recall(plan_p)
        if any(r.probes != plan_p
               or abs(r.predicted_recall - want_pred) > 1e-9
               for r in planned):
            fail(f"recall_target={target} was not planned from the ladder")
        # the escalations the ladder prescribes, and n_scored charged for
        # every budget that ran
        budgets = ladder_budgets(target)
        want_tier = ("exact" if budgets[-1] >= total
                     else "escalated" if len(budgets) > 1 else "approx")
        want_n = np.zeros(N_QUERIES, np.int64)
        for p in budgets:
            run = (eng.search_exact(qw, k=K, exclude=excl) if p >= total
                   else eng.search(qw, probes=p, k=K, exclude=excl))
            want_n += run[2].cpu().numpy()
        if any(r.probes != budgets[-1] or r.tier != want_tier
               or r.escalations != len(budgets) - 1 for r in floored):
            fail(f"min_recall={target} responses do not follow the ladder's "
                 f"budgets {budgets}")
        if [r.n_scored for r in floored] != want_n.tolist():
            fail(f"min_recall={target}: n_scored is not the sum over the "
                 f"budgets that ran")
    for msg in mutation_failures:
        fail(f"mutation path: {msg}")
    for msg in baseline_failures:
        fail(f"baselines path: {msg}")
    for msg in serving_failures:
        fail(f"serving path: {msg}")
    for msg in sharded_failures:
        fail(f"sharded path: {msg}")
    if not same_build:
        fail("two builds of one index on the card differ")
    if not replay_same:
        fail("the build replayed phase by phase differs from Retriever.build")
    if not d300_ok:
        fail("fused differs from reference at D = 300")
    if err300 > BST_Q_ATOL or ov300 < BST_Q_OVERLAP:
        fail(f"bucket_score_tiled bf16 at D = 300: err {err300}, overlap "
             f"{ov300}")
    if not qt32_ok:
        fail("query_tile=32 differs from the default tile")
    ok_rows = rows_without_near_ties(ref_k1)
    if not np.array_equal(f_ids[ok_rows], r_ids[ok_rows]):
        fail("fused ids differ from reference ids")
    if [r.n_scored for r in fused] != [r.n_scored for r in ref]:
        fail("fused n_scored differs from reference")
    if not np.allclose(f_sc, r_sc, atol=SCORE_ATOL, equal_nan=False):
        fail(f"fused scores differ from reference by "
             f"{np.nanmax(np.abs(f_sc - r_sc))}")
    e_ids = np.stack([r.doc_ids for r in exact])
    e_sc = np.stack([r.scores for r in exact])
    gt_ok = rows_without_near_ties(gt_s)
    if not np.array_equal(e_ids[gt_ok], gt_i[gt_ok, :K]):
        fail("exact tier differs from brute force")
    if not np.allclose(e_sc, gt_s[:, :K], atol=SCORE_ATOL):
        fail("exact-tier scores differ from brute force")
    # Not gated: the int8 exact tier is exact only when every true
    # neighbour is among the 4k best int8 scores; the count is a finding.
    e8_ids = np.stack([r.doc_ids for r in exact_int8])
    e8_same = int(np.sum(np.all(e8_ids == gt_i[:, :K], axis=1)))
    log(f"int8 exact tier (4k = {4 * K} int8 candidates, fp32 rescore): "
        f"{e8_same}/{N_QUERIES} rows equal brute force; top-{K} overlap "
        f"{overlap(e8_ids, gt_i[:, :K]):.4f}")
    log(f"fused == reference on {int(ok_rows.sum())}/{N_QUERIES} rows free of "
        f"near ties (scores within {SCORE_ATOL} on all), n_scored equal; "
        f"exact tier == brute force on {int(gt_ok.sum())}/{N_QUERIES}")
    for pack_dtype, floor in OVERLAP_FLOORS.items():
        q_ids = np.stack([r.doc_ids for r in quant[pack_dtype][1]])
        ov = overlap(q_ids, f_ids)
        log(f"{pack_dtype} pack: top-{K} overlap with fp32 {ov:.4f} "
            f"(floor {floor})")
        if ov < floor:
            fail(f"{pack_dtype} overlap {ov} below {floor}")
    for r in fused:
        for h in r.hits:
            if abs(sum(h.field_scores.values()) - h.score) > 1e-4:
                fail("field scores do not sum to the score")
    if not all(np.isfinite(r.scores).all() and len(r.hits) == K
               for r in fused):
        fail("a fused answer is short or not finite")

    # -------------------------------------------------- recsys path (H)
    # paths A-G are gated; drop path A's pack (the largest state they
    # leave; G dropped the bf16 / int8 indexes) so the recsys models and the
    # 1M-candidate index have the card
    index.drop_packs()
    h = recsys_path(dev, zero_counts, read_counts, uncounted)
    print(json.dumps({"recsys": h["json"]}, default=str), flush=True)
    for msg in h["failures"]:
        fail(f"recsys path: {msg}")

    kernels = [
        {"name": "fpf_iter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fpf_iter.cu",
         "replaces": "src/repro/kernels/fpf_iter/kernel.py:25",
         "launches": launches["fpf_iter"], "max_abs_err": fpf_err,
         "ms": fpf_ms, "plain_ms": fpf_plain_ms, "bound_ms": fpf_bound_ms,
         "bound_by": fpf_bound_by, "library_ms": None},
        {"name": "bucket_score_tiled", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bucket_score_tiled.cu",
         "replaces": "src/repro/kernels/bucket_score/kernel.py:100",
         "launches": launches["bucket_score_tiled"],
         "max_abs_err": bst_err["float32"], "ms": bst_ms,
         "plain_ms": bst_plain_ms, "bound_ms": bst_bound_ms,
         "bound_by": bst_bound_by, "library_ms": None},
        {"name": "topk_score", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_score.cu",
         "replaces": "src/repro/kernels/topk_score/kernel.py:26",
         "launches": quality_launches["topk_score"],
         "max_abs_err": topk_err, "ms": topk_ms, "plain_ms": topk_plain_ms,
         "bound_ms": topk_bound_ms, "bound_by": topk_bound_by,
         "library_ms": None},
        {"name": "bucket_score", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bucket_score.cu",
         "replaces": "src/repro/kernels/bucket_score/kernel.py:65",
         "launches": bench_launches["bucket_score"],
         "max_abs_err": v1_err["float32"], "ms": v1_ms["float32"],
         "plain_ms": v1_plain_ms, "bound_ms": v1_bound_ms,
         "bound_by": v1_bound_by, "library_ms": None},
        {"name": "embed_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/embed_bag.cu",
         "replaces": "src/repro/kernels/embed_bag/kernel.py:25",
         **h["embed_bag_row"]},
    ]
    log(f"build {build_s:.1f}s (kernels) + {build_index_s:.2f}s (index); "
        f"paths A-H {time.perf_counter() - t_start:.1f}s")
    return {"kernels": kernels, "card": card, "dev": dev, "t_start": t_start,
            "counters": (zero_counts, read_counts, uncounted)}


def lm_bytes(cfg) -> dict:
    """Bytes path J needs on the card for ``cfg``, reckoned on the host:
    the bf16 weights; the batch's cache at ``max_seq_len``; the largest
    transient of one layer at J_BATCH x (J_PROMPT + 1) tokens (attention:
    q, k, v and their head-major copies, a block pair's fp32 scores and
    their softmax temporaries; FFN: fp32 h1, h3 and their products; MoE:
    the (E, C, D) buffers at the check's capacity factor and the slots'
    rows); and the check forward's fp32 logits, all positions, beside the
    last layer's activations. The cache is freed before that forward, so
    the total is the weights plus the larger of (cache + transient) and
    (logits + activations)."""
    from repro_torch.models import transformer as tf

    b, s = J_BATCH, J_PROMPT + 1
    t = b * s
    d, hq, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    qc, kc = min(cfg.attn_q_chunk, s), min(cfg.attn_kv_chunk, s)
    out = {"weights": 2 * tf.count_params(cfg),
           "cache": 2 * cfg.n_layers * b * cfg.max_seq_len * hk * dh * 2}
    attn = (2 * t * (hq + 2 * hk) * dh * 2 + 2 * t * hq * dh * 2
            + 5 * b * hq * qc * kc * 4)
    if cfg.moe is None:
        ffn = 5 * t * cfg.d_ff * 4
    else:
        m = cfg.moe
        cap = tf.moe_capacity(t, dataclasses.replace(
            m, capacity_factor=max(J_CHECK_CF, m.capacity_factor)))
        ffn = (2 * m.n_experts * cap * d * 2
               + 5 * m.n_experts * cap * m.d_expert * 4
               + t * m.top_k * d * (2 + 4)
               + 5 * t * m.d_expert * m.n_shared * 4)
    acts = 6 * t * d * 2
    out["layer_transient"] = acts + max(attn, ffn)
    out["forward_logits"] = t * cfg.vocab * 4 + acts
    out["total"] = out["weights"] + max(
        out["cache"] + out["layer_transient"], out["forward_logits"])
    return out


def lm_flops_and_bounds(cfg) -> dict:
    """Model flops of a prefill (the work this run does: every weight's
    product for every prompt token, unembed for the last position only,
    and the blockwise attention over every kv block, 4 B S^2 Hq dh a
    layer) and the bounds of a prefill and of a decode step (bf16 peak;
    HBM: a decode step reads every weight but the embedding table, which
    it gathers B rows of, and the whole max_seq_len cache)."""
    from repro_torch.models import transformer as tf

    b, s = J_BATCH, J_PROMPT
    unembed = cfg.vocab * cfg.d_model
    body = tf.active_params(cfg) - unembed
    attn = 4.0 * b * s * s * cfg.n_heads * cfg.d_head * cfg.n_layers
    flops = 2.0 * body * b * s + 2.0 * unembed * b + attn
    weights = 2.0 * (tf.count_params(cfg) - unembed)
    cache = 2.0 * cfg.n_layers * b * cfg.max_seq_len * cfg.n_kv_heads \
        * cfg.d_head * 2
    prefill_bytes = weights + cache * s / cfg.max_seq_len
    decode_bytes = weights + 2.0 * b * cfg.d_model + cache
    return {"prefill_flops": flops,
            "prefill_bound_ms": 1e3 * max(flops / BF16_FLOPS,
                                          prefill_bytes / HBM_BYTES_PER_S),
            "prefill_bound_by": ("operations" if flops / BF16_FLOPS
                                 > prefill_bytes / HBM_BYTES_PER_S
                                 else "bytes"),
            "decode_bytes": decode_bytes,
            "decode_bound_ms": 1e3 * decode_bytes / HBM_BYTES_PER_S,
            "decode_bound_by": "bytes"}


class RoutingLog:
    """Wraps ``transformer.moe_ffn`` while in use: records each call's
    expert choice (the same router product, softmax and stable top-k) and
    its largest expert load against the capacity."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.core.engine import stable_topk
        from repro_torch.models import transformer as tf

        self._real = real = tf.moe_ffn

        def moe_ffn(x2d, p, cfg, mcfg):
            probs = torch.softmax(tf._mm32(x2d, p["router"]), dim=-1)
            _, expert = stable_topk(probs, mcfg.top_k)
            load = expert.reshape(-1).bincount(minlength=mcfg.n_experts)
            self.calls.append((expert, load.max(),
                               tf.moe_capacity(x2d.shape[0], mcfg)))
            return real(x2d, p, cfg, mcfg)

        tf.moe_ffn = moe_ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf

        tf.moe_ffn = self._real

    def drops(self) -> int:
        """Calls in which an expert got more slots than its capacity."""
        return sum(int(load) > cap for _, load, cap in self.calls)


def decode_against_forward(params, toks, cfg) -> dict:
    """The first greedy decode step after ``prefill(toks)`` against
    ``forward`` on the sequences extended by that token (last position),
    with the numbers the gate reads (j_decode_tol at cfg.n_layers)."""
    import gc

    import torch

    from repro_torch.models import transformer as tf

    with RoutingLog() as routing:
        logits, cache = tf.prefill(params, toks, cfg)
        nxt = logits.argmax(-1).to(torch.int32)
        step, cache = tf.decode_step(params, cache, nxt, cfg)
        del cache
        gc.collect()
        full, _ = tf.forward(params, torch.cat([toks, nxt[:, None]], 1), cfg)
        full = full[:, -1].clone()
    tol, rms_tol = j_decode_tol(cfg.n_layers)
    delta = (step - full).abs()
    top2 = full.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * delta.amax(dim=-1)
    agree = step.argmax(-1) == full.argmax(-1)
    return {"layers": cfg.n_layers,
            "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
            "max_abs_err": float(delta.max()), "tol": tol,
            "rel_rms_err": float(delta.square().mean().sqrt()
                                 / full.square().mean().sqrt()),
            "rms_tol": rms_tol, "rows_clear": int(clear.sum()),
            "top1_agree_clear": int(agree[clear].sum()),
            "top1_agree_all": int(agree.sum()),
            "moe_calls_over_capacity": routing.drops()}


def block_against_cpu(model, toks, cfg) -> dict:
    """Block 0 of the served weights on J_BLOCK_TOKENS tokens of row 0:
    the card's output against the port's CPU output on the same inputs
    and weights (per-token tolerance, outliers counted)."""
    import torch

    from repro_torch.models import transformer as tf

    p = tf._tree(model)
    blk = tf._flatten(tf._block(p["layers"], 0))
    x = tf._embed(p, toks[:1, :J_BLOCK_TOKENS], cfg)
    pos = torch.arange(J_BLOCK_TOKENS, device=x.device)[None]
    outs = []
    for where in (x.device, torch.device("cpu")):
        on = tf._tree({k: v.to(where) for k, v in blk.items()})
        with RoutingLog() as routing:
            y, _, _ = tf.block_fn(on, x.to(where), cfg, pos.to(where))
        outs.append((y[0].float().cpu(), [e.cpu() for e, _, _ in
                                          routing.calls]))
    (got, e_card), (want, e_cpu) = outs
    same = torch.ones(J_BLOCK_TOKENS, dtype=torch.bool)
    for a, b in zip(e_card, e_cpu):
        same &= (a.sort(-1).values == b.sort(-1).values).all(-1)
    scale = float(want.abs().max())
    tol = J_BLOCK_TOL * scale
    per_token = (got - want).abs().amax(-1)
    inside = per_token <= tol
    d = (got - want)[inside]
    return {"tokens": J_BLOCK_TOKENS, "max_abs_err": float(per_token.max()),
            "tol": tol, "out_max": scale,
            "outliers": int((~inside).sum()),
            "rel_rms_err": float(d.square().mean().sqrt()
                                 / want[inside].square().mean().sqrt()),
            "rms_tol": J_BLOCK_RMS, "route_flips": int((~same).sum())}


def lm_serve(dev, cfg, seed, failures) -> dict:
    """One LM configuration on the card at full width: weights drawn from
    ``seed``, J_REPS + 1 rounds of prefill + J_STEPS greedy decode steps
    (CUDA events), the decode-vs-forward check, the full-width block
    against the CPU. Returns the run's numbers."""
    import gc

    import torch

    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as tf

    name = cfg.name
    need = lm_bytes(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    parts = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in need.items())
    log(f"LM {name}: {tf.count_params(cfg)} parameters; reckoned "
        f"{need['total'] / 1e9:.2f} GB ({parts}), free {free / 1e9:.2f} GB")
    if need["total"] > free:
        fail(f"LM path: {name} needs {need['total']} bytes as reckoned, "
             f"{free} are free on the card")
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = tf.Transformer(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.as_tensor(lm_batch(cfg.vocab, J_BATCH, J_PROMPT, step=0)[0],
                           device=dev)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    prefill_ms, decode_ms = [], []
    with torch.inference_mode():
        finite = torch.ones((), dtype=torch.bool, device=dev)
        for rep in range(1 + J_REPS):
            cache = None
            ev_p, ev_d = events(), events()
            ev_p[0].record()
            logits, cache = tf.prefill(model, toks, cfg)
            ev_p[1].record()
            finite &= torch.isfinite(logits).all()
            nxt = logits.argmax(-1).to(torch.int32)
            ev_d[0].record()
            for _ in range(J_STEPS):
                logits, cache = tf.decode_step(model, cache, nxt, cfg)
                finite &= torch.isfinite(logits).all()
                nxt = logits.argmax(-1).to(torch.int32)
            ev_d[1].record()
            torch.cuda.synchronize()
            if rep:
                prefill_ms.append(ev_p[0].elapsed_time(ev_p[1]))
                decode_ms.append(ev_d[0].elapsed_time(ev_d[1]) / J_STEPS)
        length = int(cache["length"])
        del cache, logits
        if not bool(finite):
            failures.append(f"{name}: non-finite logits in prefill or decode")
        if length != J_PROMPT + J_STEPS:
            failures.append(f"{name}: cache length {length}, expected "
                            f"{J_PROMPT + J_STEPS}")

        # the first decode step against forward on the 2,049-token rows,
        # at full depth and (gated for qwen2-moe) on its first layers
        ccfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=J_CHECK_CF))
        check = {"full_depth": decode_against_forward(model, toks, ccfg)}
        n_cut = J_CHECK_LAYERS.get(name)
        if n_cut:
            nb = n_cut // tf._n_sub(cfg)
            cut = {k: v[:nb] if k.startswith("layers.") else v
                   for k, v in model.named_parameters()}
            check["gated"] = decode_against_forward(
                cut, toks, dataclasses.replace(ccfg, n_layers=n_cut))
        else:
            check["gated"] = check["full_depth"]
        g = check["gated"]
        if (g["max_abs_err"] > g["tol"] or g["rel_rms_err"] > g["rms_tol"]
                or g["top1_agree_clear"] != g["rows_clear"]):
            failures.append(f"{name}: first decode step against forward: "
                            f"{g}")

        # one full-width block: the card against the port's CPU path
        block = block_against_cpu(model, toks, cfg)
        if (block["outliers"] > J_BLOCK_OUTLIERS * J_BLOCK_TOKENS
                or block["rel_rms_err"] > J_BLOCK_RMS):
            failures.append(f"{name}: full-width block on the card against "
                            f"the CPU: {block}")

    bounds = lm_flops_and_bounds(cfg)
    p_ms, d_ms = float(np.median(prefill_ms)), float(np.median(decode_ms))
    rate = bounds["prefill_flops"] / (p_ms * 1e-3)
    run = {"params": tf.count_params(cfg), "active_params":
           tf.active_params(cfg), "dtype": str(cfg.dtype),
           "batch": J_BATCH, "prompt": J_PROMPT, "decode_steps": J_STEPS,
           "init_s": init_s, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": J_BATCH * J_PROMPT / (p_ms * 1e-3),
           "model_flops_per_s": rate, "bf16_peak_share": rate / BF16_FLOPS,
           "decode_ms_per_step": decode_ms, **bounds,
           "decode_bound_share": bounds["decode_bound_ms"] / d_ms,
           "cache_length": length, "decode_check": check, "block_check": block,
           "reckoned_bytes": need, "free_bytes": free,
           "allocated_at_start": at_start,
           "peak_allocated": torch.cuda.max_memory_allocated(dev) - at_start}
    log(f"LM {name}: init {init_s:.2f} s; prefill {J_BATCH} x {J_PROMPT} "
        f"{p_ms:.1f} ms (bound {bounds['prefill_bound_ms']:.1f}, "
        f"{bounds['prefill_bound_by']}), {run['prefill_tokens_per_s']:.0f} "
        f"tokens/s, {rate / 1e12:.1f} model TFLOP/s ({rate / BF16_FLOPS:.1%} "
        f"of the bf16 peak); decode {d_ms:.2f} ms a step (bound "
        f"{bounds['decode_bound_ms']:.2f}, bytes); check {check}; block "
        f"{block}; peak allocated by the run {run['peak_allocated'] / 1e9:.2f} "
        f"GB (reckoned {need['total'] / 1e9:.2f}; {at_start / 1e9:.2f} GB "
        f"allocated before it)")
    del model
    return run


def lm_train_config():
    """examples/train_lm.py's ~100M qwen3-style config (train_lm.py:13-18;
    its dtype is the default fp32), as the port's example holds it."""
    from repro_torch.examples.train_lm import CONFIG

    return CONFIG


def lm_train(dev, failures) -> dict:
    """``lm_train_config()`` trained J_TRAIN['steps'] steps on the card:
    ``loss_fn``, the backward through the per-block checkpoint,
    ``adamw(3e-4)``."""
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cfg = lm_train_config()
    model = tf.Transformer(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw(J_TRAIN["lr"])
    state = opt.init(params)
    losses, fb_ms, opt_ms = [], [], []
    for step in range(J_TRAIN["steps"]):
        toks, labels = lm_batch(cfg.vocab, J_TRAIN["batch"],
                                J_TRAIN["seq_len"], step=step)
        toks = torch.as_tensor(toks, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, _ = tf.loss_fn(model, toks, labels, cfg)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        ev[1].record()
        _, state = opt.update(grads, state, params)
        ev[2].record()
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
        fb_ms.append(ev[0].elapsed_time(ev[1]))
        opt_ms.append(ev[1].elapsed_time(ev[2]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (np.isfinite(losses).all() and last < first - J_LEARN_MARGIN):
        failures.append(f"LM training did not learn: mean of the first 5 "
                        f"losses {first:.4f}, of the last 5 {last:.4f}")
    n = tf.count_params(cfg)
    tokens = J_TRAIN["batch"] * J_TRAIN["seq_len"]
    step_ms = float(np.median(np.add(fb_ms, opt_ms)[1:]))
    # 6 N T for forward + backward, + 2 N T for the remat recompute
    flops = 8.0 * tf.active_params(cfg) * tokens
    out = {"config": cfg.name, "params": n, "dtype": str(cfg.dtype),
           **J_TRAIN, "losses": losses, "first5": first, "last5": last,
           "fwd_bwd_ms": fb_ms, "optimizer_ms": opt_ms,
           "step_ms_median": step_ms,
           "model_flops_per_s": flops / (step_ms * 1e-3),
           "fp32_peak_share": flops / (step_ms * 1e-3) / FP32_FLOPS}
    log(f"LM training {cfg.name} ({n} parameters, fp32): {J_TRAIN['steps']} "
        f"steps of {J_TRAIN['batch']} x {J_TRAIN['seq_len']}, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f} (first 5 {first:.3f}, last 5 "
        f"{last:.3f}); {step_ms:.1f} ms a step (median after the first), "
        f"{out['model_flops_per_s'] / 1e12:.2f} model TFLOP/s")
    del model, params, state, opt
    return out


def lm_path(dev, zero_counts, read_counts) -> dict:
    """Path J: qwen3-8b and qwen2-moe-a2.7b served at full width in bf16,
    one after the other (each freed before the next), then the ~100M
    training run. The LM family reaches none of the five kernels: every
    count must stay 0."""
    import gc

    import torch

    from repro_torch.configs import get_arch

    failures = []
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    runs = {}
    for seed, arch in enumerate(J_ARCHS):
        runs[arch] = lm_serve(dev, get_arch(arch).make_config(), seed,
                              failures)
        gc.collect()
        torch.cuda.empty_cache()
    train = lm_train(dev, failures)
    launches = read_counts()
    if any(launches.values()):
        failures.append(f"the LM path launched a retrieval kernel: {launches}")
    return {"json": {"runs": runs, "train": train, "launches": launches,
                     "path_s": time.perf_counter() - t0},
            "failures": failures}


def lm_train_bytes(cfg, batch: int, seq: int) -> dict:
    """Bytes one ``train_lm`` step of ``cfg`` holds on the card at its
    peak, reckoned on the host: the parameters and their gradients in
    ``cfg.dtype`` and the two fp32 moments; each block's checkpointed
    input; one block recomputed in the backward (``lm_bytes``'s layer
    transient at these tokens, twice for its gradients); the loss's fp32
    tensors at ``batch x seq`` tokens (``matmul32``'s fp32 copy of
    ``unembed`` under autograd and its gradient, the logits,
    ``log_softmax``'s output and their two gradients in the backward);
    and the optimizer's fp32 temporaries on its largest leaf (of the cast
    gradient, its clipped copy, the update, the second moment's quotient
    and the cast parameter, two live at once). The step's peak is the
    state plus the larger of the backward's and the optimizer's
    transients."""
    import torch

    from repro_torch.models import transformer as tf

    n = tf.count_params(cfg)
    item = torch.empty((), dtype=cfg.dtype).element_size()
    t = batch * seq
    d, hq, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    qc, kc = min(cfg.attn_q_chunk, seq), min(cfg.attn_kv_chunk, seq)
    attn = (2 * t * (hq + 2 * hk) * dh * 2 + 2 * t * hq * dh * 2
            + 5 * batch * hq * qc * kc * 4)
    ffn = 5 * t * cfg.d_ff * 4
    block = 2 * (6 * t * d * item + max(attn, ffn))
    loss = (4 * t + 2 * d) * cfg.vocab * 4
    largest = max(int(np.prod(s)) for s in tf.param_specs(cfg).values())
    out = {"params": n * item, "grads": n * item, "moments": 8 * n,
           "checkpointed": cfg.n_layers * t * d * item,
           "backward_transient": block + loss,
           "optimizer_transient": 2 * 4 * largest}
    out["total"] = (out["params"] + out["grads"] + out["moments"]
                    + out["checkpointed"] + max(out["backward_transient"],
                                                out["optimizer_transient"]))
    return out


class StepEvents:
    """Wraps ``train_lm``'s gradient and optimizer calls while in use: CUDA
    events before the gradients, between them and the optimizer, and after
    the optimizer, one triple a step."""

    def __enter__(self):
        import torch

        from repro_torch.launch import train as tr

        self.steps = []
        self._tr = tr
        self._acc, self._adamw = tr.accumulate_gradients, tr.adamw
        log = self

        def accumulate_gradients(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = log._acc(*args, **kw)
            ev[1].record()
            log.steps.append(ev)
            return out

        def adamw(*args, **kw):
            opt = log._adamw(*args, **kw)

            def update(grads, state, params):
                out = opt.update(grads, state, params)
                log.steps[-1][2].record()
                return out

            return dataclasses.replace(opt, update=update)

        tr.accumulate_gradients, tr.adamw = accumulate_gradients, adamw
        return self

    def __exit__(self, *exc):
        self._tr.accumulate_gradients, self._tr.adamw = self._acc, self._adamw

    def split_ms(self) -> tuple[list, list]:
        """(forward + backward ms, optimizer ms) a step."""
        return ([a.elapsed_time(b) for a, b, _ in self.steps],
                [b.elapsed_time(c) for _, b, c in self.steps])


def _host_leaf(x):
    return x if isinstance(x, int) else x.detach().cpu().clone()


def same_bits(a, b) -> bool:
    """Leaves equal bit for bit (an int, or a tensor of one dtype/shape)."""
    import torch

    if isinstance(a, int) or isinstance(b, int):
        return type(a) is type(b) and a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


class CheckpointLog:
    """Wraps ``CheckpointManager.save`` / ``restore`` while in use: a host
    copy of every leaf each save wrote (by step) and each restore
    returned, and their seconds."""

    def __enter__(self):
        from repro_torch.checkpoint import manager as cm

        self.saved, self.restored, self.save_s, self.restore_s = {}, [], [], []
        self._cls = cls = cm.CheckpointManager
        self._save, self._restore = cls.save, cls.restore
        log = self

        def save(mgr, step, tree, *, extra=None):
            t0 = time.perf_counter()
            out = log._save(mgr, step, tree, extra=extra)
            log.save_s.append(time.perf_counter() - t0)
            log.saved[step] = [_host_leaf(x) for x in cm.flatten(tree)]
            return out

        def restore(mgr, tree_like, *, step=None):
            t0 = time.perf_counter()
            tree, at, extra = log._restore(mgr, tree_like, step=step)
            log.restore_s.append(time.perf_counter() - t0)
            log.restored.append((at, [_host_leaf(x)
                                      for x in cm.flatten(tree)]))
            return tree, at, extra

        cls.save, cls.restore = save, restore
        return self

    def __exit__(self, *exc):
        self._cls.save, self._cls.restore = self._save, self._restore


def k_full_width(dev, failures) -> dict:
    """``train_lm`` on qwen3-8b at make_config() widths in bf16, at the
    largest whole number of blocks whose reckoning fits K_MEM_SHARE of the
    card's free memory: K_WARMUP + K_STEPS steps, the last K_STEPS timed
    (CUDA events) and split into forward + backward and the optimizer."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as tf

    full = get_arch(K_ARCH).make_config()
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    need_full = lm_train_bytes(full, K_BATCH, K_SEQ)
    blocks = 0
    for nb in range(full.n_layers, 0, -1):
        cut = dataclasses.replace(full, n_layers=nb)
        if lm_train_bytes(cut, K_BATCH, K_SEQ)["total"] <= K_MEM_SHARE * free:
            blocks = nb
            break
    if not blocks:
        fail(f"training driver: one block of {K_ARCH} does not fit "
             f"{K_MEM_SHARE} of the {free} free bytes")
    cfg = dataclasses.replace(full, n_layers=blocks)
    need = lm_train_bytes(cfg, K_BATCH, K_SEQ)
    n = tf.count_params(cfg)
    parts = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in need.items())
    log(f"train_lm {K_ARCH} at full width, {blocks} of {full.n_layers} "
        f"blocks (all {full.n_layers} reckoned {need_full['total'] / 1e9:.1f} "
        f"GB): {n} parameters; reckoned {need['total'] / 1e9:.2f} GB "
        f"({parts}), free {free / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with StepEvents() as ev:
        model, losses = train_lm(
            cfg, steps=K_WARMUP + K_STEPS, batch=K_BATCH, seq_len=K_SEQ,
            lr=K_LR, log_every=10 ** 9, device=dev)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - at_start
    del model
    fb_ms, opt_ms = (x[K_WARMUP:] for x in ev.split_ms())
    if not np.isfinite(losses).all():
        failures.append(f"{K_ARCH} training: non-finite losses {losses}")
    tokens = K_BATCH * K_SEQ
    active = tf.active_params(cfg)
    step_ms = float(np.median(np.add(fb_ms, opt_ms)))
    flops = 6.0 * active * tokens
    opt_bound_ms = 1e3 * K_ADAMW_BYTES * n / HBM_BYTES_PER_S
    run = {"arch": K_ARCH, "blocks": blocks, "params": n,
           "active_params": active, "dtype": str(cfg.dtype),
           "batch": K_BATCH, "seq_len": K_SEQ, "lr": K_LR,
           "losses": losses, "fwd_bwd_ms": fb_ms, "optimizer_ms": opt_ms,
           "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms * 1e-3),
           "model_flops_per_s": flops / (step_ms * 1e-3),
           "bf16_peak_share": flops / (step_ms * 1e-3) / BF16_FLOPS,
           "optimizer_bound_ms": opt_bound_ms,
           "optimizer_bound_share": opt_bound_ms
           / float(np.median(opt_ms)),
           "wall_s": wall_s, "reckoned_bytes": need,
           "reckoned_all_blocks": need_full["total"], "free_bytes": free,
           "peak_allocated": peak,
           "checkpoint_bytes_if_written": 10 * n,
           "reduced": {"n_layers": [full.n_layers, blocks]}}
    log(f"train_lm {K_ARCH} ({blocks} blocks, bf16, {K_BATCH} x {K_SEQ}): "
        f"losses {[round(x, 4) for x in losses]}; {step_ms:.1f} ms a step "
        f"(forward + backward {np.median(fb_ms):.1f}, optimizer "
        f"{np.median(opt_ms):.1f} vs its {opt_bound_ms:.2f} ms byte bound); "
        f"{run['tokens_per_s']:.0f} tokens/s, "
        f"{run['model_flops_per_s'] / 1e12:.1f} model TFLOP/s "
        f"({run['bf16_peak_share']:.1%} of the bf16 peak); peak allocated "
        f"{peak / 1e9:.2f} GB (reckoned {need['total'] / 1e9:.2f}); no "
        f"checkpoint ({10 * n / 1e9:.1f} GB if written)")
    return run


def k_resume(dev, dtype, failures) -> dict:
    """The ~100M config in ``dtype``: K_RESUME["steps"] steps uninterrupted
    against a run to K_RESUME["at"] with a checkpoint directory and a
    resume from it; every restored leaf against the saved one, bit for
    bit, and the resumed losses against the uninterrupted run's."""
    import shutil
    import tempfile

    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(lm_train_config(), dtype=dtype)
    run = dict(batch=K_RESUME["batch"], seq_len=K_RESUME["seq_len"],
               lr=K_RESUME["lr"], log_every=10 ** 9, device=dev)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _, whole = train_lm(cfg, steps=K_RESUME["steps"], **run)
        with CheckpointLog() as ck:
            _, first = train_lm(cfg, steps=K_RESUME["at"], ckpt_dir=d,
                                ckpt_every=K_RESUME["ckpt_every"], **run)
            _, rest = train_lm(cfg, steps=K_RESUME["steps"], ckpt_dir=d,
                               ckpt_every=K_RESUME["ckpt_every"], **run)
        disk = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    name = str(dtype).replace("torch.", "")
    if len(ck.restored) != 1:
        failures.append(f"{name} resume: {len(ck.restored)} restores")
        return {"dtype": name, "restores": len(ck.restored)}
    (at, got), = ck.restored
    want = ck.saved.get(at, [])
    same = [same_bits(a, b) for a, b in zip(got, want)]
    tensors = [x for x in got if not isinstance(x, int)]
    restored_dtypes = sorted({str(x.dtype).replace("torch.", "")
                              for x in tensors})
    # the parameters are the tree's last leaves ("params" sorts last)
    n_params = len(tf.param_specs(cfg))
    param_dtypes = sorted({str(x.dtype).replace("torch.", "")
                           for x in tensors[-n_params:]})
    diff = (np.abs(np.subtract(rest, whole[K_RESUME["at"]:])).max()
            if len(rest) == len(whole) - K_RESUME["at"] else None)
    out = {"dtype": name, "steps": K_RESUME["steps"], "resumed_at": at,
           "leaves": len(got), "leaves_bit_equal": int(sum(same)),
           "restored_dtypes": restored_dtypes,
           "restored_param_dtypes": param_dtypes,
           "losses_uninterrupted": whole, "losses_first": first,
           "losses_resumed": rest, "max_abs_loss_diff": diff,
           "saves": sorted(ck.saved), "save_s": ck.save_s,
           "restore_s": ck.restore_s, "disk_bytes_at_end": disk}
    if at != K_RESUME["at"] or not same or sum(same) != len(want):
        failures.append(f"{name} resume: {sum(same)} of {len(want)} leaves "
                        f"restored bit-equal at step {at}")
    if param_dtypes != [name]:
        failures.append(f"{name} resume restored parameters in "
                        f"{param_dtypes}")
    if diff is None or diff > K_RESUME_ATOL or not np.isfinite(whole).all():
        failures.append(f"{name} resume: losses {rest} against the "
                        f"uninterrupted {whole[K_RESUME['at']:]}")
    log(f"checkpoint {cfg.name} {name}: {len(got)} leaves restored at step "
        f"{at}, {sum(same)} bit-equal, parameters in {param_dtypes}; resumed "
        f"losses vs uninterrupted max |diff| {diff}; saves at "
        f"{sorted(ck.saved)} in {[round(s, 2) for s in ck.save_s]} s, "
        f"restore {[round(s, 2) for s in ck.restore_s]} s")
    return out


def k_preempt(dev, failures) -> dict:
    """``python -m repro_torch.launch.train --arch qwen3-8b --smoke`` in a
    subprocess on ``dev``, SIGTERM after its first logged step: it must
    exit 0 with a checkpoint at the step it names, and an in-process
    resume runs only the remaining steps."""
    import contextlib
    import io
    import queue
    import shutil
    import signal
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm

    d = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           K_ARCH, "--smoke", "--steps", str(K_PREEMPT_STEPS), "--ckpt-dir",
           d, "--ckpt-every", str(K_PREEMPT_STEPS), "--device", str(dev)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    out, signalled, first_s = [], False, None
    try:
        deadline = time.perf_counter() + K_PREEMPT_TIMEOUT_S
        while True:
            line = lines.get(timeout=max(deadline - time.perf_counter(), 0.1))
            if line is None:
                break
            out.append(line.rstrip("\n"))
            if not signalled and line.startswith("[train] step 0 "):
                proc.send_signal(signal.SIGTERM)
                signalled, first_s = True, time.perf_counter() - t0
        rc = proc.wait(timeout=K_PREEMPT_TIMEOUT_S)
    except queue.Empty:
        rc = None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    wall_s = time.perf_counter() - t0
    named = [int(ln.split("checkpointed at ")[1].split(",")[0])
             for ln in out if "preempted -> checkpointed at " in ln]
    res = {"cmd": " ".join(cmd[1:]), "exit": rc, "signalled": signalled,
           "first_step_s": first_s, "wall_s": wall_s, "output": out[-6:]}
    try:
        steps = CheckpointManager(d).steps()
        res["checkpoints"] = steps
        if rc != 0 or not signalled or len(named) != 1 or steps != named:
            failures.append(f"preemption: exit {rc}, signalled {signalled}, "
                            f"named {named}, checkpoints {steps}: {out[-6:]}")
            return res
        at = named[0]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, losses = train_lm(
                get_arch(K_ARCH).make_smoke_config(), steps=K_PREEMPT_STEPS,
                batch=8, seq_len=128, ckpt_dir=d, ckpt_every=K_PREEMPT_STEPS,
                log_every=10 ** 9, device=dev)
        res.update(checkpointed_at=at, resumed_steps=len(losses),
                   resume_log=buf.getvalue().strip())
        if (len(losses) != K_PREEMPT_STEPS - at
                or f"resumed from step {at}" not in buf.getvalue()
                or not np.isfinite(losses).all()):
            failures.append(f"preemption: the resume from {at} ran "
                            f"{len(losses)} steps of {K_PREEMPT_STEPS}: "
                            f"{buf.getvalue().strip()}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"preemption: `{res['cmd']}` got SIGTERM {first_s}s after start, "
        f"exit {rc}, checkpointed at {res.get('checkpointed_at')}, the "
        f"in-process resume ran {res.get('resumed_steps')} steps "
        f"({wall_s:.1f}s)")
    return res


def train_driver_path(dev, zero_counts, read_counts) -> dict:
    """Path K: ``train_lm`` at full width (depth cut), the checkpoint
    round trip in fp32 and bf16, and SIGTERM on the CLI. The LM family
    reaches none of the five kernels: every count must stay 0."""
    import gc

    import torch

    failures = []
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    phase_s = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        return out

    full = timed("full_width", lambda: k_full_width(dev, failures))
    resume = {name: timed(f"resume_{name}", lambda: k_resume(
        dev, getattr(torch, name), failures))
        for name in ("float32", "bfloat16")}
    preempt = timed("preemption", lambda: k_preempt(dev, failures))
    log(f"training driver phases (s): {phase_s}")
    launches = read_counts()
    if any(launches.values()):
        failures.append(f"the training driver launched a retrieval kernel: "
                        f"{launches}")
    return {"json": {"full_width": full, "resume": resume,
                     "preemption": preempt, "launches": launches,
                     "phase_s": phase_s,
                     "path_s": time.perf_counter() - t0},
            "failures": failures}


def gcn_shapes():
    """The reference's four gcn-cora shapes (configs/gcn_cora.py
    cells()), as the port's GCNConfig."""
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import GCNConfig

    arch = "gcn-cora"
    return {
        "full_graph_sm": get_arch(arch).make_config(),
        "minibatch_lg": GCNConfig(name=arch, n_layers=2,
                                  d_in=L_REDDIT["d_feat"], d_hidden=16,
                                  n_classes=L_REDDIT["n_classes"]),
        "ogb_products": GCNConfig(name=arch, n_layers=2,
                                  d_in=L_PRODUCTS["d_feat"], d_hidden=16,
                                  n_classes=L_PRODUCTS["n_classes"]),
        "molecule": GCNConfig(name=arch, n_layers=2,
                              d_in=L_MOLECULE["d_feat"], d_hidden=16,
                              n_classes=L_MOLECULE["n_classes"],
                              readout="mean"),
    }


def gnn_full_bytes(n: int, e: int, cfg) -> dict:
    """One full-batch training step, reckoned on the host from the shapes.

    ``traffic``: the least HBM bytes. The coefficients read the edge list
    and write ``ssafe``, ``dsafe`` and ``coeff`` (20 B an edge). Each
    propagation (layers 0 and 1 forward, layer 1's input gradient in the
    backward; layer 0 has none, the features take no gradient) reads those
    12 B an edge, each edge's source row (4 d B) and each node's own row,
    and writes each node's aggregate (8 d B a node). Each product reads
    its input and writes its output; the backward reads both again for
    the weight's gradient and writes the input's gradient of layer 1.

    ``memory``: the peak the port holds. The features, the edge list and
    the three per-edge tensors, plus the larger of layer 0's ``(E,
    d_in)`` message buffer with its ``(n, d_in)`` aggregates (three) and
    the backward's two ``(E, d_hidden)`` message gradients."""
    d0, dh, c = cfg.d_in, cfg.d_hidden, cfg.n_classes

    def prop(d):
        return 12 * e + 4 * d * e + 8 * d * n

    products = 4 * n * (2 * d0 + 5 * dh + 2 * c)
    traffic = 20 * e + prop(d0) + 2 * prop(dh) + products
    base = 4 * n * d0 + 8 * e + 12 * e
    memory = base + max(4 * d0 * e + 12 * d0 * n, 8 * dh * e + 12 * dh * n)
    return {"traffic": traffic, "bound_ms": 1e3 * traffic / HBM_BYTES_PER_S,
            "memory": memory}


def gnn_train(dev, cfg, loss_fn, *, seed, host_batch=None) -> dict:
    """L_STEPS steps of ``loss_fn(params, batch)`` with adamw(L_LR) from
    ``gcn_init(seed)``; ``host_batch(step)`` (host clock) makes each
    step's batch. CUDA events around the device part of each step."""
    import torch

    from repro_torch.models.gnn import gcn_init
    from repro_torch.optim import adamw

    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    params = gcn_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    opt = adamw(L_LR)
    state = opt.init(params)
    losses, dev_ms, host_ms = [], [], []
    for step in range(L_STEPS):
        t0 = time.perf_counter()
        batch = host_batch(step) if host_batch is not None else None
        host_ms.append(1e3 * (time.perf_counter() - t0))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        params, state = opt.update(grads, state, params)
        ev[1].record()
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
        dev_ms.append(ev[0].elapsed_time(ev[1]))
    return {"losses": losses, "device_ms": dev_ms,
            "device_ms_median": float(np.median(dev_ms[1:])),
            "host_ms": host_ms if host_batch is not None else None,
            "host_ms_median": (float(np.median(host_ms[1:]))
                               if host_batch is not None else None),
            "peak_allocated": torch.cuda.max_memory_allocated(dev) - at_start}


def gnn_cora_against_cpu(dev, cfg, g) -> dict:
    """One Cora step's logits, loss and gradients on the card against the
    port's CPU path on the same weights and inputs (L_CPU_RTOL of each
    tensor's largest |value|)."""
    import torch

    from repro_torch.models.gnn import gcn_forward, gcn_init, gcn_loss

    card = gcn_init(cfg, torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    cpu = {k: v.detach().cpu().requires_grad_(True) for k, v in card.items()}
    mask = (np.arange(g.n_nodes) % 2 == 0).astype(np.float32)
    outs = []
    for params in (card, cpu):
        where = next(iter(params.values())).device
        x, e, y, m = (torch.as_tensor(a, device=where) for a in (
            g.features, g.edge_index, g.labels, mask))
        with torch.no_grad():
            logits = gcn_forward(params, x, e, cfg)
        loss = gcn_loss(params, x, e, y, m, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        outs.append([logits.cpu(), loss.detach().cpu()]
                    + [t.cpu() for t in grads])
    names = ["logits", "loss"] + [f"grad_{k}" for k in card]
    errs = {}
    for name, got, want in zip(names, *outs):
        scale = float(want.abs().max()) or 1.0
        errs[name] = float((got - want).abs().max()) / scale
    return {"rel_err": errs, "rtol": L_CPU_RTOL,
            "ok": all(v <= L_CPU_RTOL for v in errs.values())}


def gnn_path(dev, zero_counts, read_counts) -> dict:
    """Path L: the four gcn-cora shapes trained on the card, Cora's step
    against the CPU. The GNN family reaches none of the five kernels:
    every count must stay 0."""
    import gc

    import torch

    from repro_torch.data import (cora_like, molecule_batch,
                                  power_law_graph, sample_khop, to_csr)
    from repro_torch.models.gnn import (gcn_loss, graph_readout_loss,
                                        sampled_loss)

    failures = []
    t_path = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    shapes = gcn_shapes()
    runs = {}

    def full_batch(name, g, seed, gen_s):
        cfg = shapes[name]
        need = gnn_full_bytes(g.n_nodes, g.n_edges, cfg)
        free = torch.cuda.mem_get_info(dev)[0]
        log(f"GCN {name}: {g.n_nodes} nodes, {g.n_edges} edges after "
            f"_symmetrize's dedup, d {cfg.d_in}, {cfg.n_classes} classes "
            f"(made in {gen_s:.1f}s); reckoned peak {need['memory'] / 1e9:.2f}"
            f" GB, free {free / 1e9:.2f} GB; least traffic "
            f"{need['traffic'] / 1e9:.2f} GB a step")
        if need["memory"] > free:
            fail(f"GNN path: {name} needs {need['memory']} bytes as "
                 f"reckoned, {free} are free on the card")
        x = torch.as_tensor(g.features, device=dev)
        e = torch.as_tensor(g.edge_index, device=dev)
        y = torch.as_tensor(g.labels, device=dev)
        m = torch.ones(g.n_nodes, device=dev)
        r = gnn_train(dev, cfg, lambda p, _: gcn_loss(p, x, e, y, m, cfg),
                      seed=seed)
        del x, e, y, m
        r.update(nodes=g.n_nodes, edges=g.n_edges, gen_s=gen_s,
                 reckoned=need, bound_share=need["bound_ms"]
                 / r["device_ms_median"])
        return r

    # Cora full batch, and one step against the CPU
    t0 = time.perf_counter()
    g = cora_like(**L_CORA)
    runs["full_graph_sm"] = full_batch("full_graph_sm", g, 0,
                                       time.perf_counter() - t0)
    runs["full_graph_sm"]["against_cpu"] = check = gnn_cora_against_cpu(
        dev, shapes["full_graph_sm"], g)
    if not check["ok"]:
        failures.append(f"Cora step on the card against the CPU: {check}")

    # ogbn-products full batch, at its published scale
    t0 = time.perf_counter()
    g = power_law_graph(**L_PRODUCTS)
    runs["ogb_products"] = full_batch("ogb_products", g, 0,
                                      time.perf_counter() - t0)
    for name in ("full_graph_sm", "ogb_products"):
        ls = runs[name]["losses"]
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            failures.append(f"GCN {name}: the loss did not fall over "
                            f"{L_STEPS} steps: {ls}")
    gc.collect()
    torch.cuda.empty_cache()

    # the sampled minibatch at its cell's widths, from the products graph:
    # the sampler on the host, the features on the card
    cfg = shapes["minibatch_lg"]
    t0 = time.perf_counter()
    indptr, indices = to_csr(g.edge_index, g.n_nodes)
    csr_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.n_classes, g.n_nodes).astype(np.int32)
    feats = torch.randn((g.n_nodes, cfg.d_in), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    feats[torch.arange(g.n_nodes, device=dev),
          torch.as_tensor(labels, device=dev).long()] += 2.0
    lut = np.zeros(g.n_nodes, np.int32)
    sizes = []

    def host_batch(step):
        rng = np.random.default_rng(step)
        seeds = rng.choice(g.n_nodes, L_SEEDS, replace=False)
        layers, node_set = sample_khop(indptr, indices, seeds, L_FANOUTS,
                                       rng=rng)
        nodes = np.concatenate([seeds, np.setdiff1d(node_set, seeds,
                                                    assume_unique=True)])
        lut[nodes] = np.arange(len(nodes), dtype=np.int32)
        lists = [np.stack([lut[s], lut[d]]) for s, d in reversed(layers)]
        sizes.append((len(nodes), [e.shape[1] for e in lists]))
        return nodes, lists, labels[seeds]

    def sampled(params, batch):
        nodes, lists, y = batch
        x = torch.index_select(feats, 0, torch.as_tensor(nodes, device=dev))
        return sampled_loss(params, x,
                            [torch.as_tensor(e, device=dev) for e in lists],
                            torch.as_tensor(y, device=dev), L_SEEDS, cfg)

    log(f"GCN minibatch_lg: sampling the products graph ({g.n_nodes} "
        f"nodes, {g.n_edges} edges; CSR made on the host in {csr_s:.1f}s), "
        f"features d {cfg.d_in} and {cfg.n_classes} classes drawn on the "
        f"card")
    r = gnn_train(dev, cfg, sampled, seed=0, host_batch=host_batch)
    r.update(nodes=g.n_nodes, edges=g.n_edges, csr_s=csr_s,
             subgraph_nodes=[s[0] for s in sizes],
             subgraph_edges=sizes[0][1], seeds=L_SEEDS,
             fanouts=list(L_FANOUTS),
             reduced={"graph": "ogbn-products' instead of Reddit's "
                      f"({L_REDDIT['n_nodes']} nodes, {L_REDDIT['n_edges']}"
                      f" edges): that graph and its CSR took "
                      f"{L_REDDIT_HOST_S} s on the host"})
    runs["minibatch_lg"] = r
    del feats, g, indptr, indices
    gc.collect()
    torch.cuda.empty_cache()

    # the molecule batch: graph_readout_loss over 128 graphs
    cfg = shapes["molecule"]
    mol = molecule_batch(**L_MOLECULE)
    x, e, gid, y = (torch.as_tensor(a, device=dev) for a in (
        mol.features, mol.edge_index, mol.graph_ids, mol.labels))
    nb = L_MOLECULE["batch"]
    r = gnn_train(dev, cfg, lambda p, _: graph_readout_loss(
        p, x, e, gid, y, nb, cfg), seed=0)
    r.update(nodes=mol.n_nodes, edges=mol.n_edges, graphs=nb)
    runs["molecule"] = r

    for name, r in runs.items():
        if not np.isfinite(r["losses"]).all():
            failures.append(f"GCN {name}: non-finite losses {r['losses']}")
        bound = (f", bound {r['reckoned']['bound_ms']:.2f} ms (bytes, "
                 f"{r['bound_share']:.1%})" if "reckoned" in r else "")
        host = (f", host sampling {r['host_ms_median']:.1f} ms"
                if r["host_ms"] is not None else "")
        log(f"GCN {name}: losses {r['losses'][0]:.4f} -> "
            f"{r['losses'][-1]:.4f}; {r['device_ms_median']:.2f} ms a step "
            f"on the card{bound}{host}; peak allocated "
            f"{r['peak_allocated'] / 1e9:.3f} GB")
    log(f"Cora step, card vs CPU: {runs['full_graph_sm']['against_cpu']}")
    launches = read_counts()
    if any(launches.values()):
        failures.append(f"the GNN path launched a retrieval kernel: "
                        f"{launches}")
    return {"json": {"shapes": runs, "launches": launches,
                     "path_s": time.perf_counter() - t_path},
            "failures": failures}


def dryrun_path() -> dict:
    """M1: ``launch.dryrun.run_cell`` of paper-retrieval's four cells on
    both production meshes (the fake process group at 256 and 512 ranks,
    the HW_H100 constants): per-chip roofline terms, predictions, not
    measurements."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out = {}
    for cell in get_arch("paper-retrieval").cells():
        for mesh in ("single", "multi"):
            r = dryrun.run_cell(cell, mesh, None)
            out[f"{cell.shape}/{mesh}"] = {
                k: r[k] for k in ("t_compute_s", "t_memory_s",
                                  "t_collective_s", "bottleneck",
                                  "hlo_flops_per_chip", "hlo_bytes_per_chip",
                                  "collective_bytes_per_chip")}
            out[f"{cell.shape}/{mesh}"]["argument_bytes"] = r[
                "memory_analysis"]["argument_size_in_bytes"]
            log(f"M1 {cell.shape} [{mesh}]: compute {r['t_compute_s']:.3e} s,"
                f" memory {r['t_memory_s']:.3e} s, collective "
                f"{r['t_collective_s']:.3e} s -> {r['bottleneck']}; "
                f"arguments {r['memory_analysis']['argument_size_in_bytes']}"
                f" B a chip")
    return {"cells": out, "path_s": time.perf_counter() - t0}


def ptxas_lines(lib: str, entry: str) -> list:
    """``-Xptxas -v``'s lines (registers, spills, stack) for the kernels of
    ``csrc/<lib>.cu`` whose mangled name holds ``entry``."""
    from repro_torch.kernels.common import build_cuda_library

    out, keep = [], False
    with open(build_cuda_library(lib) + ".ptxas.txt") as f:
        for ln in f:
            if "Compiling entry function" in ln:
                keep = entry in ln
            elif keep and ("registers" in ln or "spill" in ln):
                out.append(ln.strip())
    return out


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def paper_shard(cfg, n: int, dev, g):
    """The clustered synthetic shard, ``(n, D)`` bf16 on the card, drawn
    ``M_CHUNK`` rows at a time (see M_TOPICS)."""
    import torch

    from repro_torch.core.fields import normalize_fields

    topics = torch.randn((M_TOPICS, cfg.d), generator=g, device=dev)
    docs = torch.empty((n, cfg.d), dtype=cfg.dtype, device=dev)
    for lo in range(0, n, M_CHUNK):
        hi = min(n, lo + M_CHUNK)
        t = torch.randint(0, M_TOPICS, (hi - lo,), generator=g, device=dev)
        x = torch.randn((hi - lo, cfg.d), generator=g, device=dev)
        x.mul_(M_NOISE).add_(topics[t])
        docs[lo:hi] = normalize_fields(x, cfg.spec).to(cfg.dtype)
        del x
    return docs


def paper_path(dev, zero_counts, read_counts, uncounted, m1, *,
               cfg=None) -> dict:
    """M2: rank 0's program of each paper-retrieval cell on the card at the
    per-chip shape of the single pod's 256 chips, with its gates, timings
    and the ``topk_score`` row of the kernels line."""
    import gc

    import torch

    from repro_torch.configs import paper_retrieval as TP
    from repro_torch.core.cluster import fpf_sample_size
    from repro_torch.core.distributed import (build_local_buckets,
                                              make_projection)
    from repro_torch.core.weights import weighted_query
    from repro_torch.kernels import fpf_centers_fused, topk_score, \
        topk_score_ref

    cfg = cfg or TP.make_config()
    failures = []
    t_path = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n = cfg.n_docs // M_SHARDS
    k, t_cl, kc = cfg.k, cfg.n_clusterings, cfg.k_clusters
    probes_t = TP.split_probes(cfg.probes, t_cl)
    g = torch.Generator(device=dev).manual_seed(M_SEED)
    zero_counts()

    t0 = time.perf_counter()
    docs = paper_shard(cfg, n, dev, g)
    src = torch.randperm(n, generator=g, device=dev)[:M_QUERIES]
    w = torch.as_tensor(np.random.default_rng(M_SEED).dirichlet(
        np.ones(len(cfg.field_dims)), M_QUERIES), dtype=torch.float32,
        device=dev)
    qw = weighted_query(docs[src].float(), w, cfg.spec).to(cfg.dtype)
    ex = src.to(torch.int32)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    log(f"M2 shard: {n} rows x {cfg.d} {cfg.dtype} "
        f"({docs.numel() * docs.element_size() / 1e9:.3f} GB), "
        f"{M_QUERIES} weighted queries, made in {data_s:.1f} s")

    # leaders: the FPF rounds of each clustering on its own sample, through
    # the fpf_iter kernel (one launch a clustering)
    t0 = time.perf_counter()
    m = fpf_sample_size(kc, n)
    leaders = torch.empty((t_cl, kc, cfg.d), dtype=cfg.dtype, device=dev)
    for t in range(t_cl):
        sample = torch.randperm(n, generator=g, device=dev)[:m]
        xs = docs[sample].float().contiguous()
        first = int(torch.randint(0, m, (1,), generator=g, device=dev))
        centers = fpf_centers_fused(xs, kc, first)
        leaders[t] = docs[sample[centers.long()]]
        del xs
    torch.cuda.synchronize()
    fpf_s = time.perf_counter() - t0
    log(f"M2 leaders: fpf_iter on {t_cl} samples of {m} rows, K = {kc}: "
        f"{fpf_s:.2f} s")

    # assignment (the build_assign cell's step, every clustering), then the
    # local buckets at bucket_pad
    assign = torch.stack([TP.build_assign_rank(docs, leaders[t])
                          for t in range(t_cl)])
    t0 = time.perf_counter()
    bkt = build_local_buckets(assign.cpu().numpy(), n, 1, kc)
    bkt, overflow = TP.pad_buckets(torch.as_tensor(bkt), cfg.bucket_pad, n)
    bkt = bkt.to(dev)
    sizes = np.bincount(assign.cpu().numpy().ravel(), minlength=kc)
    host_s = time.perf_counter() - t0
    log(f"M2 buckets: largest {int(sizes.max())} members, "
        f"{overflow} members past bucket_pad {cfg.bucket_pad} dropped "
        f"({overflow / (t_cl * n):.2%}); host packing {host_s:.2f} s")
    proj = make_projection(cfg.d, M_PROJ).to(dev)
    docs_proj = torch.empty((n, M_PROJ), dtype=cfg.dtype, device=dev)
    for lo in range(0, n, M_CHUNK):
        docs_proj[lo:lo + M_CHUNK] = (docs[lo:lo + M_CHUNK].float() @ proj
                                      ).to(cfg.dtype)
    qw_proj = (qw.float() @ proj).to(cfg.dtype)

    # the counted run: each cell's program once
    def online():
        return TP.gather_merge(*TP.serve_online_rank(
            docs, leaders, bkt[0], qw, probes_t=probes_t, k=k, offset=0,
            exclude=ex), k)

    def prefilter():
        return TP.gather_merge(*TP.serve_online_rank(
            docs, leaders, bkt[0], qw, probes_t=probes_t, k=k, offset=0,
            exclude=ex, docs_proj_l=docs_proj, qw_proj=qw_proj), k)

    def brute():
        return TP.gather_merge(*TP.serve_brute_rank(
            docs, qw, k=k, offset=0, n_valid=n, exclude=ex), k)

    s_on, i_on = online()
    s_pf, i_pf = prefilter()
    s_br, i_br = brute()
    torch.cuda.synchronize()
    launches = read_counts()
    tc_launches = topk_score.tc_launches
    log(f"M2 launches: {launches}; topk_score on the tensor cores "
        f"{tc_launches}")
    if launches["topk_score"] < 1:
        failures.append(f"serve_brute did not launch topk_score: {launches}")
    if tc_launches != 1:
        failures.append(f"serve_brute took the tensor-core core "
                        f"{tc_launches} times, expected once")
    if launches["bucket_score_tiled"] != 0:
        failures.append(f"the gather oracle launched bucket_score_tiled: "
                        f"{launches}")

    # gates
    def check_ids(name, ids):
        a = ids.cpu().numpy()
        bad = (a < 0) | (a >= n) | (a == ex.cpu().numpy()[:, None])
        if bad.any():
            failures.append(f"{name}: {int(bad.sum())} excluded, sentinel or "
                            f"out-of-range ids")
        dup = sum(len(set(r)) != len(r) for r in a.tolist())
        if dup:
            failures.append(f"{name}: {dup} rows repeat an id")

    rows = docs.float()
    exact = {}
    for name, (sc, ids) in (("serve_online", (s_on, i_on)),
                            ("serve_online_prefilter", (s_pf, i_pf)),
                            ("serve_brute", (s_br, i_br))):
        check_ids(name, ids)
        re = torch.einsum("qkd,qd->qk", rows[ids.long().clamp(0, n - 1)],
                          qw.float()).to(torch.bfloat16).float()
        err = (sc - re).abs().cpu().numpy() / bf16_ulp(re.cpu().numpy())
        exact[name] = float(err.max())
        if not (err <= 1.0).all():
            failures.append(f"{name}: a returned score is {err.max():.2f} "
                            f"bf16 ulps from its exact bf16 rescore")
    del rows

    plain_s, plain_i = uncounted("topk_score", lambda: topk_score_ref(
        qw, docs, k=k + 1, exclude=ex, round_bf16=True))
    ps, pi = plain_s.cpu().numpy(), plain_i.cpu().numpy()
    ks, ki = s_br.cpu().numpy(), i_br.cpu().numpy()
    pos_err = np.abs(ks - ps[:, :k]) / bf16_ulp(ps[:, :k])
    if not (pos_err <= 1.0).all():
        failures.append(f"serve_brute: a score is {pos_err.max():.2f} ulps "
                        f"from the plain version's at its position")
    # ids: equal on rows without near ties (neighbours more than one ulp
    # apart), and on rows whose bf16 scores equal the plain version's at
    # every position (ties then go to the lower id in both)
    gaps = -np.diff(ps, axis=1) / bf16_ulp(ps[:, 1:])
    clear = np.all(gaps > 1.0, axis=1)
    same = np.all(ks == ps[:, :k], axis=1)
    for rows_ok, what in ((clear, "without near ties"),
                          (same, "with equal scores")):
        mism = int((ki[rows_ok] != pi[rows_ok, :k]).any(axis=1).sum())
        if mism:
            failures.append(f"serve_brute: {mism} of {int(rows_ok.sum())} "
                            f"rows {what} differ from the plain version")
    topk_err = float(np.max(np.abs(ks - ps[:, :k])))
    log(f"M2 serve_brute vs its plain version: ids equal on the "
        f"{int(clear.sum())} rows without near ties and the "
        f"{int(same.sum())} of {M_QUERIES} rows with equal scores; max "
        f"|score diff| {topk_err:.3e}; rescore ulps {exact}")

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(
            ids.cpu().numpy().tolist(), ki.tolist())]))

    rec = {"serve_online": recall(i_on), "serve_online_prefilter":
           recall(i_pf)}
    log(f"M2 recall@{k} against serve_brute (not gated): {rec}")

    # timings (not counted): each program, then topk_score alone beside its
    # plain version and the library's composite yardsticks
    def counted_free(fn):
        return uncounted("topk_score", fn)

    ms = {
        "serve_online": events_ms(online, M_REPS),
        "serve_online_prefilter": events_ms(prefilter, M_REPS),
        "serve_brute": counted_free(lambda: events_ms(brute, M_REPS)),
        "build_assign": events_ms(
            lambda: TP.build_assign_rank(docs, leaders[0]), M_REPS),
    }
    # topk_score's two bf16 cores in turns (tensor cores, the CUDA-core
    # core forced, tensor cores again), then the composite and the plain
    # version
    def core_ms(core, reps=M_REPS):
        return counted_free(lambda: events_ms(lambda: topk_score(
            qw, docs, k=k, exclude=ex, round_bf16=True, core=core), reps))

    tc_turns = [core_ms("tc")]
    fma_ms = core_ms("fma", 3)
    tc_turns.append(core_ms("tc"))
    kernel_ms = float(np.mean(tc_turns))
    lib_bf16_ms = events_ms(lambda: torch.topk((qw @ docs.T).float(), k),
                            M_REPS)
    plain_ms = events_ms(lambda: topk_score_ref(
        qw, docs, k=k, exclude=ex, round_bf16=True), 3)
    docs32 = docs.float()
    qw32 = qw.float()
    lib_fp32_ms = events_ms(lambda: torch.topk(qw32 @ docs32.T, k), M_REPS)
    del docs32
    nbytes = (docs.numel() + qw.numel()) * 2 + M_QUERIES * 4 + \
        M_QUERIES * k * 8
    flops = 2.0 * M_QUERIES * n * cfg.d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS * 1e3
    bound_ms = max(by_bytes, by_ops)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    log(f"M2 topk_score at {M_QUERIES} x {n} x {cfg.d} bf16 (round_bf16): "
        f"tensor-core core {tc_turns[0]:.4f} / {tc_turns[1]:.4f} ms (turns "
        f"1 and 3), the CUDA-core core {fma_ms:.3f} ms (turn 2), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; bytes "
        f"{by_bytes:.3f}, operations {by_ops:.3f}); torch.topk(q @ docs.T) "
        f"bf16 {lib_bf16_ms:.3f} ms, fp32 {lib_fp32_ms:.3f} ms")
    tc_ptxas = ptxas_lines("topk_score", "topk_score_tc_kernel")
    log(f"M2 ptxas of the tensor-core core: {tc_ptxas}")
    if not kernel_ms < min(lib_bf16_ms, fma_ms):
        failures.append(f"the tensor-core core ({kernel_ms:.3f} ms) is not "
                        f"faster than the composite ({lib_bf16_ms:.3f}) and "
                        f"the CUDA-core core ({fma_ms:.3f})")
    ratios = {}
    for shape, t_ms in ms.items():
        r = m1["cells"].get(f"{shape}/single") if m1 else None
        if r:
            pred = max(r["t_compute_s"], r["t_memory_s"]) * 1e3
            ratios[shape] = t_ms / pred if pred > 0 else None
            log(f"M2 {shape}: {t_ms:.3f} ms on the card (median of "
                f"{M_REPS}); M1's single-pod roofline {pred:.3f} ms "
                f"(compute {r['t_compute_s'] * 1e3:.3f}, memory "
                f"{r['t_memory_s'] * 1e3:.3f}, collective "
                f"{r['t_collective_s'] * 1e3:.3f}); ratio "
                f"{ratios[shape]:.2f}")
        else:
            log(f"M2 {shape}: {t_ms:.3f} ms on the card")
    row = {"launches": launches["topk_score"], "max_abs_err": topk_err,
           "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "core": "tc"}
    return {"json": {"n_rows": n, "d": cfg.d, "queries": M_QUERIES,
                     "k_clusters": kc, "bucket_pad": cfg.bucket_pad,
                     "overflow": overflow, "largest_bucket": int(sizes.max()),
                     "fpf_sample": m, "fpf_s": fpf_s, "launches": launches,
                     "ms": ms, "ratio_to_m1": ratios, "recall": rec,
                     "rescore_ulps": exact, "topk_score_ms": kernel_ms,
                     "topk_score_tc_turns_ms": tc_turns,
                     "topk_score_fma_ms": fma_ms,
                     "topk_score_tc_launches": tc_launches,
                     "topk_score_tc_ptxas": tc_ptxas,
                     "topk_score_plain_ms": plain_ms,
                     "topk_score_bound_ms": bound_ms,
                     "torch_topk_bf16_ms": lib_bf16_ms,
                     "torch_topk_fp32_ms": lib_fp32_ms,
                     "reduced": ["n_docs: the single-pod per-chip share "
                                 f"({n} of {cfg.n_docs})"],
                     "path_s": time.perf_counter() - t_path},
            "topk_row": row, "failures": failures}


def host_probe_ms(reps: int = 5) -> float:
    """Median ms of a fixed host workload (a pure-Python loop and ten
    256 x 256 numpy products): the host's own speed, comparable between
    runs where the machine reports no CPU model or load."""
    a = np.random.default_rng(0).standard_normal((256, 256))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i
        for _ in range(10):
            a @ a
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def host_cpu() -> str:
    """The CPU's name from /proc/cpuinfo ("model name", else vendor,
    family and model), else what ``platform`` knows."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                fields.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    if fields.get("model name"):
        return fields["model name"]
    parts = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
             if fields.get(k)]
    return ", ".join(parts) or platform.processor() or platform.machine()


def host_line(path_s: dict, load_at_start: tuple, probe_at_start: float
              ) -> dict:
    """Each path's wall seconds beside the host it ran on (CPU, cores,
    load averages and :func:`host_probe_ms` at the start and the end), so
    that a slower run can be told from a slower machine."""
    return {"host": {"cpu": host_cpu(), "cores": os.cpu_count(),
                     "load_at_start": list(load_at_start),
                     "load_at_end": list(os.getloadavg()),
                     "probe_ms_at_start": round(probe_at_start, 3),
                     "probe_ms_at_end": round(host_probe_ms(), 3)},
            "path_s": {k: round(v, 3) for k, v in path_s.items()}}


def main() -> int:
    load0, probe0 = os.getloadavg(), host_probe_ms()
    res = paths_a_to_h()
    if isinstance(res, int):
        return res
    import torch

    path_s = {"A_to_H": time.perf_counter() - res["t_start"]}

    def span(name, t0):
        path_s[name] = time.perf_counter() - t0

    # ------------------------------------------------ training path (I)
    # after the gates of A-H, with their tensors freed
    t0 = time.perf_counter()
    t = train_path(res["dev"], *res["counters"])
    span("I", t0)
    t["json"]["script_s"] = time.perf_counter() - res["t_start"]
    print(json.dumps({"train": t["json"]}, default=str), flush=True)
    for msg in t["failures"]:
        fail(f"training path: {msg}")
    del t

    # ------------------------------------------------------ LM path (J)
    # after path I, with its tensors freed
    t0 = time.perf_counter()
    lm = lm_path(res["dev"], *res["counters"][:2])
    span("J", t0)
    lm["json"]["script_s"] = time.perf_counter() - res["t_start"]
    print(json.dumps({"lm": lm["json"]}, default=str), flush=True)
    for msg in lm["failures"]:
        fail(f"LM path: {msg}")
    lm_s = lm["json"]["path_s"]
    del lm

    # -------------------------------------------- training driver path (K)
    # after path J, with its tensors freed
    t0 = time.perf_counter()
    k = train_driver_path(res["dev"], *res["counters"][:2])
    span("K", t0)
    k["json"]["script_s"] = time.perf_counter() - res["t_start"]
    print(json.dumps({"train_driver": k["json"]}, default=str), flush=True)
    for msg in k["failures"]:
        fail(f"training driver path: {msg}")
    k_s = k["json"]["path_s"]
    del k

    # ----------------------------------------------------- GNN path (L)
    t0 = time.perf_counter()
    g = gnn_path(res["dev"], *res["counters"][:2])
    span("L", t0)
    g["json"]["script_s"] = time.perf_counter() - res["t_start"]
    print(json.dumps({"gnn": g["json"]}, default=str), flush=True)
    for msg in g["failures"]:
        fail(f"GNN path: {msg}")
    gnn_s = g["json"]["path_s"]
    del g

    # ------------------------------------------------ paper-retrieval (M)
    t0 = time.perf_counter()
    m1 = dryrun_path()
    span("M1", t0)
    print(json.dumps({"dryrun": m1}, default=str), flush=True)
    zero, read, uncounted = res["counters"]
    t0 = time.perf_counter()
    m = paper_path(res["dev"], zero, read, uncounted, m1)
    span("M2", t0)
    m["json"]["script_s"] = time.perf_counter() - res["t_start"]
    print(json.dumps({"paper": m["json"]}, default=str), flush=True)
    for msg in m["failures"]:
        fail(f"paper-retrieval path: {msg}")
    for row in res["kernels"]:
        if row["name"] == "topk_score":
            row.update(m["topk_row"])
    log(f"path seconds: J {lm_s:.1f}, K {k_s:.1f}, L {gnn_s:.1f}, M "
        f"{m1['path_s'] + m['json']['path_s']:.1f} (M1 {m1['path_s']:.1f})")
    log(f"whole run {time.perf_counter() - res['t_start']:.1f}s")
    path_s["whole"] = time.perf_counter() - res["t_start"]
    print(json.dumps(host_line(path_s, load0, probe0)), flush=True)
    print(json.dumps({"kernels": res["kernels"]}))
    print(res["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   CUDA ``topk_score`` kernel. Kernels-bench path (C), counts at 0 again:
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
3. Kernels against their plain PyTorch versions on the paths' own inputs
   (their launches are not counted).
4. Timing with CUDA events, next to each kernel's bound and, where one
   PyTorch call computes the same function, that call's time; the fused
   batch split into navigation, schedule, scoring launch, merge launch and
   decomposition; ``bucket_score`` (v1) on the three packs at the main
   path's 64 x 12 flat probes, each split into inversion, scoring launch
   and merge launch; ``embed_bag`` and ``F.embedding_bag`` both as device time
   (a CUDA graph of 200 calls) and back to back per call.
5. The gates; then a ``kernels`` JSON line (all five kernels), the card
   line, and as the last line ``{"ok": true, "device": {...}}``.

Any failed gate exits non-zero without the last line. Without a CUDA card,
or outside a checkout (no ``src/repro_torch`` beside this file), it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def main() -> int:
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

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    def uncounted(name, fn):
        """Call ``fn`` without adding its launches to ``name``'s count, or
        its rounds to ``fpf_iter``'s (comparisons with the plain version,
        timing loops and the build replay)."""
        before = wrappers[name].launches, fpf_iter.rounds
        try:
            return fn()
        finally:
            wrappers[name].launches, fpf_iter.rounds = before

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
    f_grid, f_rows, f_cached, _, _ = fpf_plan(
        m, 2048, torch.cuda.get_device_properties(dev).multi_processor_count)
    rows_in_smem = sum(min(f_cached, m - b_ * f_rows) for b_ in range(f_grid))
    # three bounds per round: the run's least time (the sample read once,
    # 2 m D flops a round: operations bound it), the design's (the rows not
    # held in shared memory read each round at the HBM rate, plus one read
    # of the sample over the run) and the earlier one, the sample read from
    # HBM every round
    fpf_run_bytes = (m * 2048 + m) * 4 + K_CLUSTERS * 8
    fpf_run_flops = 2 * m * 2048 * n_rounds
    fpf_bound_ms = max(fpf_run_bytes / HBM_BYTES_PER_S,
                       fpf_run_flops / FP32_FLOPS) * 1e3 / n_rounds
    fpf_bound_by = ("bytes" if fpf_run_bytes / HBM_BYTES_PER_S
                    >= fpf_run_flops / FP32_FLOPS else "operations")
    fpf_design_ms = ((m - rows_in_smem) * 2048 * 4 / HBM_BYTES_PER_S
                     + m * 2048 * 4 / HBM_BYTES_PER_S / n_rounds) * 1e3
    fpf_hbm_round_ms = (m * 2048 + 2 * m) * 4 / HBM_BYTES_PER_S * 1e3

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
        f"{fpf_bound_ms:.6f} by {fpf_bound_by}, the design's "
        f"{fpf_design_ms:.5f} ({rows_in_smem} of {m} rows held in shared "
        f"memory on {f_grid} CTAs), the sample from HBM every round "
        f"{fpf_hbm_round_ms:.4f}; one fpf_iter() call {fpf_call_ms:.4f} ms")
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

    table_ext = torch.cat([table, table.new_zeros((1, BENCH_E))])
    idx_ext = torch.where(bidx >= 0, bidx, BENCH_V).long()
    lib_out = torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="sum", padding_idx=BENCH_V)
    lib_diff = float((lib_out - embed_bag_ref(table, bidx)).abs().max())

    def lib_sum():
        return torch.nn.functional.embedding_bag(
            idx_ext, table_ext, mode="sum", padding_idx=BENCH_V)

    # back to back per call (host work included: launch-bound), then device
    # time from a CUDA graph; kernel and library in turns
    eb_ms = uncounted("embed_bag", lambda: cuda_ms(
        lambda: embed_bag(table, bidx), 200))
    eb_lib_ms = cuda_ms(lib_sum, 200)
    eb_ms2 = uncounted("embed_bag", lambda: cuda_ms(
        lambda: embed_bag(table, bidx), 200))
    eb_lib_ms2 = cuda_ms(lib_sum, 200)
    eb_dev_ms = uncounted("embed_bag", lambda: graph_ms(
        lambda: embed_bag(table, bidx)))
    try:
        eb_lib_dev_ms = graph_ms(lib_sum)
    except RuntimeError as e:       # a library call that cannot be captured
        eb_lib_dev_ms = None
        log(f"F.embedding_bag in a CUDA graph: not measured ({e})")
    eb_plain_ms = cuda_ms(lambda: embed_bag_ref(table, bidx), 20)
    eb_lib_mean_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="mean", padding_idx=BENCH_V), 200)
    eb_lib_w_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="sum", padding_idx=BENCH_V,
        per_sample_weights=bw), 200)
    eb_w_ms = uncounted("embed_bag", lambda: cuda_ms(
        lambda: embed_bag(table, bidx, bw), 200))
    n_valid = int((bidx >= 0).sum())
    eb_bytes = (n_valid * BENCH_E * 4 + bidx.numel() * 4
                + BENCH_B * BENCH_E * 4)
    eb_flops = 2 * n_valid * BENCH_E
    eb_bound_ms = max(eb_bytes / HBM_BYTES_PER_S,
                      eb_flops / FP32_FLOPS) * 1e3
    lib_dev = "not measured" if eb_lib_dev_ms is None else f"{eb_lib_dev_ms:.5f}"
    log(f"embed_bag: back to back {eb_ms:.4f} / {eb_ms2:.4f} ms per call "
        f"(F.embedding_bag sum {eb_lib_ms:.4f} / {eb_lib_ms2:.4f}, in turns); "
        f"device time (CUDA graph of 200) {eb_dev_ms:.5f} ms (F.embedding_bag "
        f"{lib_dev}); plain {eb_plain_ms:.4f}; bound {eb_bound_ms:.5f} by "
        f"bytes, {eb_bytes / 1e6:.2f} MB; weighted {eb_w_ms:.4f} "
        f"(F.embedding_bag per_sample_weights {eb_lib_w_ms:.4f}), "
        f"F.embedding_bag mean {eb_lib_mean_ms:.4f} ms; its sum differs from "
        f"the plain version by {lib_diff:.3g}")

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
         "launches": bench_launches["embed_bag"], "max_abs_err": eb_err,
         "ms": eb_ms, "plain_ms": eb_plain_ms, "bound_ms": eb_bound_ms,
         "bound_by": "bytes", "library_ms": eb_lib_ms},
    ]
    log(f"build {build_s:.1f}s (kernels) + {build_index_s:.2f}s (index); "
        f"whole run {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

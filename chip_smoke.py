#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

What it does, in order:

1. Card and build: prints the card's name and power limit (nvidia-smi),
   compiles the four CUDA sources with nvcc (``sm_90a``; one nvcc each, all
   started together) and the Triton kernel, side by side, and prints the
   build time.
2. Main path (A) at the paper's scale — 100,000 Citeseer-like documents, the
   default field widths 512/512/1024 (D = 2048), K = 316 clusters
   (sqrt(n)), T = 3 clusterings. With every launch counter at 0 it builds
   the index through ``Retriever.build(method="auto")`` (``fpf_fused``: every
   FPF round is the Triton ``fpf_iter`` kernel), serves 64 more-like-this
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
   builds on the card are bit-identical.
3. Kernels against their plain PyTorch versions on the paths' own inputs
   (their launches are not counted).
4. Timing with CUDA events, next to each kernel's bound and, where one
   PyTorch call computes the same function, that call's time.
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
# bucket_score (v1): fp32 query x fp32 or widened bf16 values on both
#   sides, so only the summation order differs.
V1_ATOL = 1e-4
# embed_bag fp32: 16 weighted fp32 terms per value in another order.
EMBED_ATOL = 1e-5
# Recall targets / floors served on the quality path: 0.9, and 0.8, which
#   on this index plans a rung below the full sweep (the default grid's fit
#   tops out under 0.9 there, so 0.9 plans T*K).
RECALL_TARGETS = (0.9, 0.8)
RECALL_SLACK = 0.05               # serve.py's held-out rule
REPAIR_DOCS, REPAIR_DIMS = 20_000, (100, 100, 100)
BENCH_V, BENCH_E, BENCH_B, BENCH_L = 100_000, 128, 256, 16
CUDA_SOURCES = ("bucket_score_tiled", "bucket_score", "topk_score",
                "embed_bag")


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
        ClusterPruneIndex, Retriever, brute_force_bottomk,
        brute_force_topk, calibrate_index, competitive_recall, get_engine,
        normalized_aggregate_goodness, weighted_query,
    )
    from repro_torch.core.cluster import fpf_sample_size
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.kernels import (
        bucket_score, bucket_score_ref, bucket_score_tiled,
        bucket_score_tiled_ref, embed_bag, embed_bag_ref, fpf_centers_fused,
        fpf_iter, fpf_iter_ref, topk_score, topk_score_ref,
    )
    from repro_torch.kernels.common import build_cuda_library, resolve_device
    from repro_torch.launch import kernels_bench
    from repro_torch.launch.serve import make_requests

    wrappers = {"fpf_iter": fpf_iter, "bucket_score_tiled": bucket_score_tiled,
                "topk_score": topk_score, "bucket_score": bucket_score,
                "embed_bag": embed_bag}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    def uncounted(name, fn):
        """Call ``fn`` without adding its launches to ``name``'s count
        (comparisons with the plain version and timing loops)."""
        before = wrappers[name].launches
        try:
            return fn()
        finally:
            wrappers[name].launches = before

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
    # Triton compiles fpf_iter per block shape, which follows the row count:
    # warm it at the build's own sample size so the index build below
    # times the build, not the compile
    m_fpf = fpf_sample_size(K_CLUSTERS, N_DOCS)
    xw = torch.nn.functional.normalize(torch.randn(
        m_fpf, 2048, generator=torch.Generator().manual_seed(1)), dim=1).to(dev)
    fpf_iter(xw, torch.tensor(0, dtype=torch.int32, device=dev),
             torch.full((m_fpf,), float("-inf"), device=dev))
    torch.cuda.synchronize()
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
    log(f"kernels built in {build_s:.1f}s ({len(CUDA_SOURCES)} nvcc + "
        f"Triton in parallel)")

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
    log(f"main path launches: {launches} ({fused_calls} fused engine calls)")
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

    # bucket_score (v1) on the flat probes of the 64 requests at probes=12
    flat = eng._flat_probes(qw, eng._probes_t(PROBES))
    v1_err, v1_out = {}, {}
    for pack_dtype, idx in (("float32", index),
                            ("bfloat16", quant["bfloat16"][0])):
        data_v, ids_v, _ = idx.ensure_bucket_major()
        s_k, i_k = uncounted("bucket_score", lambda: bucket_score(
            qw, data_v, ids_v, flat, k=K + 1, exclude=excl))
        s_p, i_p = bucket_score_ref(qw, data_v, ids_v, flat, k=K + 1,
                                    exclude=excl)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        err = float(np.abs(s_k - s_p)[np.isfinite(s_p)].max())
        v1_err[pack_dtype] = err
        v1_out[pack_dtype] = (s_k, i_k)
        ok = rows_without_near_ties(s_p)
        if (err > V1_ATOL or not np.array_equal(np.isfinite(s_k),
                                                np.isfinite(s_p))
                or not np.array_equal(i_k[ok, :K], i_p[ok, :K])):
            fail(f"bucket_score (v1) {pack_dtype}: err {err}, ids differ on "
                 f"{int(np.sum(np.any(i_k != i_p, 1)))} rows")
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
        f"requests "
        f"x {int(flat.shape[1])} flat probes, k={K + 1}); vs "
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

    before = fpf_iter.launches
    # per round as the build runs it: back to back inside fpf_centers_fused
    fpf_ms = cuda_ms(lambda: fpf_centers_fused(x, rounds + 1, 5), 5) / rounds
    fpf_plain_ms = cuda_ms(plain_rounds, 5) / rounds
    fpf_call_ms = cuda_ms(lambda: fpf_iter(x, cur0, ms0), 200)
    fpf_bound_ms = (m * 2048 + 2 * m) * 4 / HBM_BYTES_PER_S * 1e3
    fpf_iter.launches = before

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
    log(f"fpf_iter: {fpf_ms:.4f} ms/round in the build loop (plain "
        f"{fpf_plain_ms:.4f}, bound {fpf_bound_ms:.4f}); one fpf_iter() call "
        f"{fpf_call_ms:.4f} ms; m={m}, D=2048")
    log(f"bucket_score_tiled fp32: {bst_ms:.3f} ms/batch (plain "
        f"{bst_plain_ms:.3f}, bound {bst_bound_ms:.4f} by {bst_bound_by}: "
        f"{uniq.numel()} unique buckets, {live_rows} live rows; "
        f"{block_reads} live block reads x B x D x 4 = {blocks_ms:.4f} ms) "
        f"at nq={N_QUERIES}, QT={member.shape[-1]}, S={sched.shape[1]}")
    for pack_dtype in OVERLAP_FLOORS:
        a2, k2 = bst_inputs[pack_dtype]
        before = bucket_score_tiled.launches
        t_q = cuda_ms(lambda: bucket_score_tiled(*a2, **k2), 20)
        bucket_score_tiled.launches = before
        log(f"bucket_score_tiled {pack_dtype}: {t_q:.3f} ms/batch")

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

    p_v1 = int(flat.shape[1])
    v1_ms = uncounted("bucket_score", lambda: cuda_ms(lambda: bucket_score(
        qw, data32, ids32, flat, k=K, exclude=excl), 20))
    v1_plain_ms = cuda_ms(lambda: bucket_score_ref(
        qw, data32, ids32, flat, k=K, exclude=excl), 3)
    v1_rows = int(counts_flat[flat.long()].sum())
    v1_bytes = (live_rows * d * 4 + uniq.numel() * b * 4 + qw.numel() * 4
                + flat.numel() * 4 + N_QUERIES * 4 + 2 * N_QUERIES * K * 4)
    v1_flops = 2 * v1_rows * d
    v1_bound_ms = max(v1_bytes / HBM_BYTES_PER_S,
                      v1_flops / FP32_FLOPS) * 1e3
    v1_bound_by = ("bytes" if v1_bytes / HBM_BYTES_PER_S
                   >= v1_flops / FP32_FLOPS else "operations")
    v1_reads_ms = N_QUERIES * p_v1 * b * d * 4 / HBM_BYTES_PER_S * 1e3
    log(f"bucket_score (v1) fp32: {v1_ms:.3f} ms/batch (plain "
        f"{v1_plain_ms:.3f}; bound {v1_bound_ms:.4f} by {v1_bound_by}, each "
        f"unique bucket once as bucket_score_tiled's; it reads "
        f"{N_QUERIES} x {p_v1} probes x B x D x 4 = {v1_reads_ms:.4f} ms of "
        f"blocks)")

    table_ext = torch.cat([table, table.new_zeros((1, BENCH_E))])
    idx_ext = torch.where(bidx >= 0, bidx, BENCH_V).long()
    lib_out = torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="sum", padding_idx=BENCH_V)
    lib_diff = float((lib_out - embed_bag_ref(table, bidx)).abs().max())
    eb_ms = uncounted("embed_bag", lambda: cuda_ms(
        lambda: embed_bag(table, bidx), 200))
    eb_plain_ms = cuda_ms(lambda: embed_bag_ref(table, bidx), 20)
    eb_lib_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="sum", padding_idx=BENCH_V), 200)
    eb_lib_mean_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="mean", padding_idx=BENCH_V), 200)
    eb_lib_w_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="sum", padding_idx=BENCH_V,
        per_sample_weights=bw), 200)
    n_valid = int((bidx >= 0).sum())
    eb_bytes = (n_valid * BENCH_E * 4 + bidx.numel() * 4
                + BENCH_B * BENCH_E * 4)
    eb_flops = 2 * n_valid * BENCH_E
    eb_bound_ms = max(eb_bytes / HBM_BYTES_PER_S,
                      eb_flops / FP32_FLOPS) * 1e3
    log(f"embed_bag: {eb_ms:.4f} ms (plain {eb_plain_ms:.4f}; bound "
        f"{eb_bound_ms:.5f} by bytes, {eb_bytes / 1e6:.2f} MB — far under "
        f"one launch's latency, so launch-bound); F.embedding_bag "
        f"(padding_idx row for -1) sum {eb_lib_ms:.4f}, mean "
        f"{eb_lib_mean_ms:.4f}, per_sample_weights {eb_lib_w_ms:.4f} ms; "
        f"its sum differs from the plain version by {lib_diff:.3g}")

    # --------------------------------------------------------- 5. gates
    if launches["fpf_iter"] < T * (K_CLUSTERS - 1):
        fail(f"fpf_iter launched {launches['fpf_iter']} times on the main "
             f"path, expected >= {T * (K_CLUSTERS - 1)}")
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
    if not same_build:
        fail("two builds of one index on the card differ")
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
        {"name": "fpf_iter", "route": "triton",
         "source": "src/repro_torch/kernels/fpf_iter/kernel.py",
         "replaces": "src/repro/kernels/fpf_iter/kernel.py:25",
         "launches": launches["fpf_iter"], "max_abs_err": fpf_err,
         "ms": fpf_ms, "plain_ms": fpf_plain_ms, "bound_ms": fpf_bound_ms,
         "bound_by": "bytes", "library_ms": None},
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
         "max_abs_err": v1_err["float32"], "ms": v1_ms,
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

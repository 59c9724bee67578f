"""Paper Table 2 on the port: CR@10 and NAG over the 7 weight sets and a
probe grid (port of ``benchmarks/table2_quality.py``)::

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_quality \
        --scale ts2 [--device cpu] [--calibration] [--out PATH]

The paper's protocol: random query documents from the corpus (self-match
excluded), k = 10, mean competitive recall in [0, 10] and mean NAG in
[0, 1] per (algorithm, weight set, visited clusters) cell, against
brute-force ground truth (the ``topk_score`` kernel on the card). Our index
is served through the typed API on the ``reference`` backend (as the
reference runs it); CellDec (k-means, 10 iterations) and PODS07 (random
leaders in CellDec's regions) answer through ``search_weighted``. The
paper's headline: ours dominates both at equal probes, more so with
unequal weights.

An ``our-exact`` row per weight set serves the exact tier (on the device's
default backend: ``fused`` on the card, over the fp32 pack of ``T·K·B·D``
floats (:func:`make_fp32_pack`), ``reference`` on the CPU). Its recall
must equal k: a miss ends the run with a non-zero exit.

``--calibration`` audits the calibrated planner instead: fit the ladder on
one seed, serve fresh Dirichlet weight draws at a grid of
``recall_target`` values, and report targeted, predicted and achieved
recall per draw.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core import (CellDecIndex, ClusterPruneIndex, Retriever,
                    SearchRequest, brute_force_bottomk, brute_force_topk,
                    calibrate_index, competitive_recall,
                    normalized_aggregate_goodness, pick_backend,
                    recall_fraction, weighted_query)
from ..kernels.common import resolve_device
from .common import (PAPER_WEIGHT_SETS, bench_sizes, make_bench_corpus,
                     make_fp32_pack, run_info, std_parser, write_json)

__all__ = ["run", "run_calibration", "main"]

K_NN = 10


def _stack(responses, dev):
    s = torch.as_tensor(np.stack([r.scores for r in responses]), device=dev)
    i = torch.as_tensor(np.stack([r.doc_ids for r in responses]), device=dev)
    return s, i


def run(scale: str = "quick", seed: int = 0, device=None,
        probe_grid=(3, 6, 9, 12, 18)) -> dict:
    dev = resolve_device(device)
    sz = bench_sizes(scale)
    docs, spec = make_bench_corpus(sz, seed, dev)
    kc = sz["k_clusters"]

    def gen():
        return torch.Generator().manual_seed(seed)

    our_index = ClusterPruneIndex.build(docs, spec, kc, n_clusterings=3,
                                        method="auto", generator=gen(),
                                        pack_major=False, device=dev)
    algos = {
        "our": Retriever(our_index, backend="reference"),
        "celldec": CellDecIndex.build(docs, spec, kc, method="kmeans",
                                      iters=10, generator=gen(), device=dev),
        "pods07": CellDecIndex.build(docs, spec, kc, method="random",
                                     generator=gen(), device=dev),
    }
    exact_backend = pick_backend(our_index)
    pack_bytes = (make_fp32_pack(our_index) if exact_backend == "fused"
                  else None)
    exact_ret = Retriever(our_index, backend=exact_backend)

    rng = np.random.default_rng(seed)
    qids = rng.choice(sz["n_docs"], sz["n_queries"], replace=False)
    qt = torch.as_tensor(qids, device=dev)
    excl = qt.to(torch.int32)
    queries = docs[qt]

    cells = []
    failures = []
    print(f"\n# Table 2 — quality (n={sz['n_docs']}, K={kc}, "
          f"{sz['n_queries']} queries, k={K_NN}, device={dev})")
    print("weights,algorithm," + ",".join(
        f"recall@p{p}" for p in probe_grid) + "," + ",".join(
        f"nag@p{p}" for p in probe_grid))
    for wname, w in PAPER_WEIGHT_SETS:
        wv = torch.tensor(w, dtype=torch.float32, device=dev).repeat(
            len(qids), 1)
        qw = weighted_query(queries, wv, spec)
        gt_s, gt_i = brute_force_topk(docs, qw, K_NN, exclude=excl)
        far_s, _ = brute_force_bottomk(docs, qw, K_NN, exclude=excl)
        wdict = dict(zip(spec.names, map(float, w)))
        for name, algo in algos.items():
            recs, nags = [], []
            for probes in probe_grid:
                if isinstance(algo, CellDecIndex):
                    s, ids, _ = algo.search_weighted(
                        queries, wv, probes=probes, k=K_NN, exclude=excl)
                else:
                    s, ids = _stack(algo.search([
                        SearchRequest(like=int(q), weights=wdict,
                                      probes=probes, k=K_NN)
                        for q in qids]), dev)
                recs.append(float(competitive_recall(ids, gt_i).mean()))
                nags.append(float(normalized_aggregate_goodness(
                    s, gt_s, far_s).mean()))
            cells.append({"weights": wname, "algorithm": name,
                          "recall": recs, "nag": nags})
            print(f"{wname},{name}," + ",".join(f"{r:.3f}" for r in recs)
                  + "," + ",".join(f"{g:.4f}" for g in nags))
        resps = exact_ret.search([
            SearchRequest(like=int(q), weights=wdict, exact=True, k=K_NN)
            for q in qids])
        _, ids = _stack(resps, dev)
        rec = float(competitive_recall(ids, gt_i).mean())
        frac = float(np.mean([r.n_scored for r in resps])) / sz["n_docs"]
        cells.append({"weights": wname, "algorithm": "our-exact",
                      "recall": [rec], "scanned": frac})
        print(f"{wname},our-exact,recall={rec:.1f}/{K_NN},"
              f"scanned={frac:.2f}x corpus")
        if rec != float(K_NN):
            failures.append(f"exact tier recall {rec} != {K_NN} for "
                            f"weights {wname}")

    mid = len(probe_grid) // 2
    uneq = [c for c in cells if c["weights"] != "equal"
            and c["algorithm"] in algos]
    mean_by_algo = {a: float(np.mean([c["recall"][mid] for c in uneq
                                      if c["algorithm"] == a]))
                    for a in algos}
    print(f"# mean recall (unequal weights, probes={probe_grid[mid]}): "
          + ", ".join(f"{a}={v:.3f}" for a, v in mean_by_algo.items()))
    return {
        **run_info("table2_quality", scale, seed, dev),
        "probe_grid": list(probe_grid), "k": K_NN,
        "exact_backend": exact_backend, "fused_pack_bytes": pack_bytes,
        "buckets_B": int(our_index.buckets.shape[-1]),
        "cells": cells,
        "mean_recall_unequal_weights_mid_probes": mean_by_algo,
        "failures": failures,
    }


def run_calibration(scale: str = "quick", seed: int = 0, device=None,
                    targets=(0.5, 0.7, 0.8, 0.9, 0.95),
                    n_draws: int = 8) -> dict:
    """Planner audit: achieved against targeted recall over held-out
    weight draws (the ladder is fitted on ``seed``, the audit draws come
    from ``seed + 1``)."""
    dev = resolve_device(device)
    sz = bench_sizes(scale)
    docs, spec = make_bench_corpus(sz, seed, dev)
    index = ClusterPruneIndex.build(
        docs, spec, sz["k_clusters"], n_clusterings=3, method="auto",
        generator=torch.Generator().manual_seed(seed), pack_major=False,
        device=dev)
    ladder = calibrate_index(index, seed=seed, backend="reference")
    print(f"\n# Planner calibration audit (n={sz['n_docs']}, "
          f"K={sz['k_clusters']}, k={K_NN}, {n_draws} held-out weight draws)")
    print("# fitted ladder: " + ", ".join(
        f"{p}->{r:.2f}" for p, r in zip(ladder.probes, ladder.recall)))
    retriever = Retriever(index, backend="reference")
    rng = np.random.default_rng(seed + 1)
    nq = min(32, sz["n_queries"])
    rows = []
    print("target,probes,predicted,achieved_mean,achieved_min,achieved_max")
    for target in targets:
        per_draw = []
        for _ in range(n_draws):
            qids = rng.choice(sz["n_docs"], nq, replace=False)
            w = rng.dirichlet(np.ones(spec.s)).astype(np.float32)
            responses = retriever.search([
                SearchRequest(like=int(q), weights=tuple(map(float, w)),
                              recall_target=target, k=K_NN)
                for q in qids])
            qt = torch.as_tensor(qids, device=dev)
            qw = weighted_query(docs[qt], torch.as_tensor(w, device=dev)
                                .repeat(nq, 1), spec)
            _, gt_i = brute_force_topk(docs, qw, K_NN,
                                       exclude=qt.to(torch.int32))
            ids = torch.as_tensor(np.stack([r.doc_ids for r in responses]),
                                  device=dev)
            per_draw.append(float(recall_fraction(ids, gt_i).mean()))
        probes, predicted = responses[0].probes, responses[0].predicted_recall
        rows.append({"target": target, "probes": probes,
                     "predicted": predicted, "achieved": per_draw})
        print(f"{target:.2f},{probes},{predicted:.3f},"
              f"{np.mean(per_draw):.3f},{min(per_draw):.3f},"
              f"{max(per_draw):.3f}")
    return {**run_info("table2_calibration", scale, seed, dev),
            "ladder": ladder.to_dict(), "rows": rows}


def main(argv=None) -> int:
    ap = std_parser(__doc__)
    ap.add_argument("--calibration", action="store_true",
                    help="audit the calibrated planner (achieved vs "
                         "targeted recall over held-out weight draws) "
                         "instead of the Table-2 grid")
    args = ap.parse_args(argv)
    if args.calibration:
        write_json(run_calibration(args.scale, args.seed, args.device),
                   args.out)
        return 0
    out = run(args.scale, args.seed, args.device)
    write_json(out, args.out)
    for msg in out["failures"]:
        print(f"# FAIL: {msg}")
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())

"""Paper Fig 1 on the port: query time against visited clusters (port of
``benchmarks/fig1_querytime.py``)::

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_querytime \
        --scale ts2 [--device cpu] [--out PATH]

The paper's claim: its scheme answers about twice as fast as CellDec at
equal visited-cluster budgets. Beside the wall time, each row carries the
distance computations per query (the paper's hardware-independent cost).

Our index is timed at two levels, on both of the port's backends
(``reference``, the doc-major gather, and ``fused``, the CUDA
``bucket_score_tiled`` kernel over the fp32 bucket-major pack) at every
probe budget:

* ``our-<backend>``: the typed API (``SearchRequest`` -> ``Retriever`` ->
  ``SearchResponse``), the surface users call: weight resolution, probe
  planning, hit construction included. Each timed call starts from empty
  request caches (a repeated batch would otherwise be served from the
  response cache).
* ``our-<backend>-engine``: ``get_engine(index, backend).search_weighted``
  on the weighted query tensors, the same kind of call as CellDec's.

CellDec (k-means, 10 iterations) answers through its own
``search_weighted``. A batch is 64 more-like-this queries with weights
0.6/0.2/0.2. Every row is timed ``REPEATS`` times after ``WARMUP`` untimed
calls, the card synchronised around each; it carries the median and the
least and largest time. The fused pack is fp32 at every scale
(:func:`make_fp32_pack`); the JSON records its bytes and the bucket size B.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core import (CellDecIndex, ClusterPruneIndex, Retriever,
                    SearchRequest, get_engine)
from ..kernels.common import resolve_device
from .common import (bench_sizes, make_bench_corpus, make_fp32_pack,
                     run_info, spread, std_parser, timed_all, write_json)

__all__ = ["run", "main"]

K_NN = 10
FIG1_WEIGHTS = (0.6, 0.2, 0.2)
REPEATS = 15
WARMUP = 2


def _mlt_requests(qids, spec, *, probes, backend):
    wd = dict(zip(spec.names, FIG1_WEIGHTS))
    return [SearchRequest(like=int(q), weights=wd, probes=probes, k=K_NN,
                          backend=backend) for q in np.asarray(qids)]


def run(scale: str = "quick", seed: int = 0, device=None,
        probe_grid=(3, 6, 9, 12, 18)) -> dict:
    dev = resolve_device(device)
    sz = bench_sizes(scale)
    docs, spec = make_bench_corpus(sz, seed, dev)
    kc = sz["k_clusters"]

    def gen():
        return torch.Generator().manual_seed(seed)

    ours = ClusterPruneIndex.build(docs, spec, kc, n_clusterings=3,
                                   method="auto", generator=gen(),
                                   pack_major=False, device=dev)
    celldec = CellDecIndex.build(docs, spec, kc, method="kmeans", iters=10,
                                 generator=gen(), device=dev)
    pack_bytes = make_fp32_pack(ours)
    backends = ("reference", "fused")
    retrievers = {be: Retriever(ours, backend=be) for be in backends}
    engines = {be: get_engine(ours, be) for be in backends}

    rng = np.random.default_rng(seed)
    nq = min(64, sz["n_queries"])
    qids = rng.choice(sz["n_docs"], nq, replace=False)
    queries = docs[torch.as_tensor(qids, device=dev)]
    wv = torch.tensor(FIG1_WEIGHTS, device=dev).repeat(nq, 1)
    excl = torch.as_tensor(qids, dtype=torch.int32, device=dev)

    print(f"\n# Fig 1 — query time vs visited clusters (n={sz['n_docs']}, "
          f"K={kc}, {nq} queries, device={dev}, fp32 pack of "
          f"{pack_bytes} bytes, B={int(ours.buckets.shape[-1])}, "
          f"{REPEATS} repeats)")
    print("probes,algo,ms_per_query_median,ms_per_query_min,"
          "ms_per_query_max,distance_computations_per_query")
    rows = []

    def row(probes, algo, ts, dc):
        ms = spread([t / nq * 1e3 for t in ts])
        rows.append({"probes": probes, "algo": algo,
                     "ms_per_query": ms["median"],
                     "ms_per_query_min": ms["min"],
                     "ms_per_query_max": ms["max"],
                     "ms_per_batch": spread([t * 1e3 for t in ts]),
                     "distance_computations_per_query": dc})

    for probes in probe_grid:
        answers = {}
        for be in backends:
            ret = retrievers[be]
            reqs = _mlt_requests(qids, spec, probes=probes, backend=be)

            def serve(ret=ret, reqs=reqs):
                ret._flush_request_caches()
                return ret.search(reqs)

            ts, resps = timed_all(serve, dev, repeats=REPEATS,
                                  warmup=WARMUP)
            answers[be] = np.stack([r.doc_ids for r in resps])
            row(probes, f"our-{be}", ts,
                float(np.mean([r.n_scored for r in resps])))
            ts, (_, ids_e, ns) = timed_all(
                lambda e=engines[be], p=probes: e.search_weighted(
                    queries, wv, probes=p, k=K_NN, exclude=excl),
                dev, repeats=REPEATS, warmup=WARMUP)
            answers[f"{be}-engine"] = ids_e.cpu().numpy()
            row(probes, f"our-{be}-engine", ts, float(ns.float().mean()))
        ts, (_, _, ns) = timed_all(lambda p=probes: celldec.search_weighted(
            queries, wv, probes=p, k=K_NN, exclude=excl), dev,
            repeats=REPEATS, warmup=WARMUP)
        row(probes, "celldec", ts, float(ns.float().mean()))
        same = int(np.sum(np.all(answers["fused"] == answers["reference"],
                                 axis=1)))
        engine_same = int(sum(np.sum(np.all(
            answers[f"{be}-engine"] == answers[be], axis=1))
            for be in backends))
        for r in rows[-5:]:
            r["fused_rows_equal_reference"] = same
            r["engine_rows_equal_api"] = engine_same
            print(f"{probes},{r['algo']},{r['ms_per_query']:.4f},"
                  f"{r['ms_per_query_min']:.4f},{r['ms_per_query_max']:.4f},"
                  f"{r['distance_computations_per_query']:.0f}")
        print(f"# probes {probes}: fused ids == reference ids on "
              f"{same}/{nq} rows; engine ids == API ids on "
              f"{engine_same}/{2 * nq}")
    return {
        **run_info("fig1_querytime", scale, seed, dev),
        "n_queries": nq, "weights": FIG1_WEIGHTS, "k": K_NN,
        "repeats": REPEATS, "warmup": WARMUP,
        "buckets_B": int(ours.buckets.shape[-1]),
        "fused_pack_bytes": pack_bytes,
        "celldec_buckets_B": [int(i.buckets.shape[-1])
                              for i in celldec.indexes],
        "rows": rows,
    }


def main(argv=None) -> int:
    args = std_parser(__doc__).parse_args(argv)
    write_json(run(args.scale, args.seed, args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

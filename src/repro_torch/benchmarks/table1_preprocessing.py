"""Paper Table 1 on the port: preprocessing time and index space (port of
``benchmarks/table1_preprocessing.py``)::

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_preprocessing \
        --scale ts2 [--device cpu] [--out PATH]

The paper's claim: FPF-on-sample preprocessing is at least thirty times
faster than CellDec's k-means and close to PODS07's random leaders, in an
index about four times smaller.

* **clusterers** — every registered clusterer timed on one clustering of
  the same corpus from the same seed (``fpf`` with plain PyTorch rounds,
  ``fpf_fused`` with the CUDA ``fpf_iter`` kernel on the card, ``kmeans``,
  ``random``).
* **index builds** — our FPF x3 index (``method="auto"``: ``fpf_fused`` on
  the card), CellDec's k-means per weight region (10 Lloyd iterations, as
  [18]) and PODS07's random leaders inside CellDec's regions: wall clock
  (the card synchronised) and index bytes (leaders + bucket ids). No build
  makes a bucket-major pack (``pack_major=False``): that is the fused
  backend's layout, made on its first search.

Every clustering and build is timed ``REPEATS`` times after one untimed
run at full size (which carries the process's first-use costs: library
loads, kernel builds, allocator growth); each row reports the median and
the JSON the least, largest and every time.
"""

from __future__ import annotations

import sys

import torch

from ..core import (CellDecIndex, ClusterPruneIndex, available_clusterers,
                    get_clusterer)
from ..kernels.common import resolve_device
from .common import (bench_sizes, make_bench_corpus, run_info, std_parser,
                     spread, timed_all, write_json)

__all__ = ["run", "main"]

REPEATS = 3


def _mb(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2**20


def run(scale: str = "quick", seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    sz = bench_sizes(scale)
    docs, spec = make_bench_corpus(sz, seed, dev)
    k = sz["k_clusters"]

    def gen():
        return torch.Generator().manual_seed(seed)

    def time_it(fn):
        ts, out = timed_all(fn, dev, repeats=REPEATS, warmup=1)
        return spread(ts), out

    print(f"\n# Table 1a — clusterer seam (n={sz['n_docs']}, K={k}, "
          f"D={spec.total_dim}, device={dev}, median of {REPEATS})")
    print("clusterer,seconds_per_clustering,min,max")
    clusterers = {}
    for name in available_clusterers():
        cl = get_clusterer(name)
        clusterers[name], _ = time_it(lambda: cl.cluster(docs, k, gen()))
        c = clusterers[name]
        print(f"{name},{c['median']:.4f},{c['min']:.4f},{c['max']:.4f}")

    s_ours, ours = time_it(lambda: ClusterPruneIndex.build(
        docs, spec, k, n_clusterings=3, method="auto", generator=gen(),
        pack_major=False, device=dev))
    s_cd, celldec = time_it(lambda: CellDecIndex.build(
        docs, spec, k, method="kmeans", iters=10, generator=gen(),
        device=dev))
    s_pods, pods = time_it(lambda: CellDecIndex.build(
        docs, spec, k, method="random", generator=gen(), device=dev))
    t_ours, t_cd, t_pods = (x["median"] for x in (s_ours, s_cd, s_pods))
    rows = [
        ("our-fpf", t_ours, _mb([ours.leaders, ours.buckets]), ours.method),
        ("celldec-kmeans", t_cd, _mb([x for i in celldec.indexes
                                      for x in (i.leaders, i.buckets)]),
         "kmeans"),
        ("pods07-random", t_pods, _mb([x for i in pods.indexes
                                       for x in (i.leaders, i.buckets)]),
         "random"),
    ]
    print(f"\n# Table 1b — end-to-end preprocessing (n={sz['n_docs']}, "
          f"K={k})")
    print("algorithm,build_seconds,min,max,index_space_MB,method")
    for (name, t, mb, method), sp in zip(rows, (s_ours, s_cd, s_pods)):
        print(f"{name},{t:.4f},{sp['min']:.4f},{sp['max']:.4f},{mb:.1f},"
              f"{method}")
    speedup = t_cd / max(t_ours, 1e-9)
    print(f"# speedup our vs celldec: {speedup:.2f}x "
          f"(paper: >=30x at 100k docs)")
    return {
        **run_info("table1_preprocessing", scale, seed, dev),
        "repeats": REPEATS,
        "clusterers": clusterers,
        "rows": [{"algorithm": n, "build_seconds": t, "index_space_mb": mb,
                  "method": m, "build_seconds_spread": sp}
                 for (n, t, mb, m), sp in zip(rows, (s_ours, s_cd,
                                                     s_pods))],
        "buckets_B": {"our": int(ours.buckets.shape[-1]),
                      "celldec": [int(i.buckets.shape[-1])
                                  for i in celldec.indexes],
                      "pods07": [int(i.buckets.shape[-1])
                                 for i in pods.indexes]},
        "speedup_vs_celldec": speedup,
        "speedup_vs_pods07": t_pods / max(t_ours, 1e-9),
    }


def main(argv=None) -> int:
    args = std_parser(__doc__).parse_args(argv)
    write_json(run(args.scale, args.seed, args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

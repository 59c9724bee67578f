"""Benchmark harness entry point on the port (port of
``benchmarks/run.py``)::

    PYTHONPATH=src python -m repro_torch.benchmarks.run \
        [--scale tiny|quick|ts1|ts2] [--device cpu] [--out PATH]

table1      preprocessing time per clusterer and per algorithm
fig1        query time + distance computations vs visited clusters
table2      recall + NAG over the paper's 7 weight sets
throughput  serving QPS vs batch size per backend and pack
loadtest    the async serving tier under load (closed / open loop)
kernels     the five CUDA kernels against their plain versions, and the
            engine backends' parity

Everything lands in ONE JSON file, by default
``src/repro_torch/benchmarks/_results/run_<scale>.json`` (git ignored).
The repository root's ``BENCH_preprocess.json`` and ``BENCH_query.json``
are the reference's CPU records and are never written here. The roofline
table waits for the dry-run slice. Exits non-zero when Table 2's exact
tier misses or a kernel or engine disagrees with its reference.
"""

from __future__ import annotations

import sys
import time

from ..kernels.common import resolve_device
from ..launch import kernels_bench
from . import (fig1_querytime, loadtest, table1_preprocessing,
               table2_quality, throughput)
from .common import run_info, std_parser, write_json

__all__ = ["main"]


def main(argv=None) -> int:
    args = std_parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.time()
    pre = table1_preprocessing.run(args.scale, args.seed, dev)
    fig1 = fig1_querytime.run(args.scale, args.seed, dev)
    table2 = table2_quality.run(args.scale, args.seed, dev)
    thr = throughput.run(args.scale, args.seed, device=dev)
    serving = loadtest.run(args.scale, args.seed, device=dev)
    kernels = kernels_bench.run(dev)
    engines = kernels_bench.run_engines(dev)
    print("# roofline: waits for the dry-run slice (the reference's "
          "roofline/analysis.py reads XLA HLO and a JAX compiled object)")
    write_json({
        **run_info("run", args.scale, args.seed, dev),
        "table1": pre, "fig1": fig1, "table2": table2, "throughput": thr,
        "serving": serving, "kernels": kernels, "engines": engines,
        "seconds": time.time() - t0,
    }, args.out)
    print(f"\n# benchmarks done in {time.time() - t0:.1f}s "
          f"(scale={args.scale}, device={dev})")
    bad = [r["kernel"] for r in kernels if not r["agrees"]]
    bad += [r["backend"] for r in engines if not r["matches_reference"]]
    if bad:
        print(f"# disagreement: {bad}", file=sys.stderr)
    return 1 if table2["failures"] or bad else 0


if __name__ == "__main__":
    sys.exit(main())

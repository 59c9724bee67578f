"""The paper's three experiments in one run on the port (port of
``examples/repro_paper.py``)::

    PYTHONPATH=src python -m repro_torch.benchmarks.repro_paper \
        [--scale ts1] [--device cpu] [--out-dir DIR]

Runs Table 1 (preprocessing), Fig 1 (query time) and Table 2 (quality, 7
weight sets) at the same scale and seed; each writes its own JSON
(``<out-dir>/<experiment>_<scale>.json``, by default in the git-ignored
``benchmarks/_results/``). Exits non-zero when Table 2's exact tier misses.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import fig1_querytime, table1_preprocessing, table2_quality

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", default="ts1",
                    choices=["tiny", "quick", "ts1", "ts2"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=None,
                    help="directory of the three JSON files")
    args = ap.parse_args(argv)
    rc = 0
    for name, mod in (("table1_preprocessing", table1_preprocessing),
                      ("fig1_querytime", fig1_querytime),
                      ("table2_quality", table2_quality)):
        argv_i = ["--scale", args.scale, "--seed", str(args.seed)]
        if args.device is not None:
            argv_i += ["--device", args.device]
        if args.out_dir is not None:
            argv_i += ["--out", os.path.join(args.out_dir,
                                             f"{name}_{args.scale}.json")]
        rc = max(rc, mod.main(argv_i))
    return rc


if __name__ == "__main__":
    sys.exit(main())

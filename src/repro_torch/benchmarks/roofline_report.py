"""Roofline table from the dry-run artifacts (port of
``benchmarks/roofline_report.py``).

Prints, per (arch x shape x mesh), the three terms, the dominant
bottleneck, the model-flops / counted-flops ratio and the per-chip memory,
then the worst roofline fraction and the most collective-bound cell among
those whose collective term is comparable with the reference's (a JSON
with ``collective_comparable: false`` is named on a line of its own). It
reads either package's JSONs (the same keys)::

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report \\
        --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load", "run"]


def load(out_dir: str = "results/dryrun_torch") -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def run(out_dir: str = "results/dryrun_torch", mesh: str | None = None):
    rows = load(out_dir)
    if not rows:
        print(f"# no dry-run artifacts under {out_dir} — run "
              "`python -m repro_torch.launch.dryrun` first")
        return []
    rows = [r for r in rows if mesh is None or r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print("\n# Roofline — per (arch x shape x mesh), terms in seconds/step")
    print("arch,shape,mesh,kind,t_compute,t_memory,t_collective,bottleneck,"
          "roofline_frac,useful_flops_ratio,temp_GiB_per_dev")
    for r in rows:
        mem = r.get("memory_analysis", {})
        temp = mem.get("temp_size_in_bytes", 0) / 2**30
        print(
            f"{r['arch']},{r['shape']},{r['mesh']},{r['kind']},"
            f"{r['t_compute_s']:.3e},{r['t_memory_s']:.3e},"
            f"{r['t_collective_s']:.3e},{r['bottleneck']},"
            f"{r['roofline_fraction']:.3f},"
            f"{r.get('useful_flops_ratio', float('nan')):.3f},{temp:.2f}"
        )

    def frac(r):
        return r["roofline_fraction"]

    worst = min(rows, key=frac)
    # the port's LM cells: a collective term that is not the reference's
    # (``collective_caveat``), left out of the collective summary
    apart = [r for r in rows if not r.get("collective_comparable", True)]
    if apart:
        print(f"# t_collective not comparable ({len(apart)} rows: "
              f"{apart[0]['collective_caveat']}): "
              + " ".join(sorted({r['arch'] for r in apart})))
    coll = max([r for r in rows if r.get("collective_comparable", True)]
               or rows,
               key=lambda r: r["t_collective_s"] /
               max(r["t_compute_s"] + r["t_memory_s"] + r["t_collective_s"],
                   1e-30))
    print(f"# worst roofline fraction: {worst['arch']}/{worst['shape']} "
          f"[{worst['mesh']}] frac={frac(worst):.4f}")
    print(f"# most collective-bound: {coll['arch']}/{coll['shape']} "
          f"[{coll['mesh']}] t_coll={coll['t_collective_s']:.3e}s")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    run(args.out, args.mesh)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Holds the port's dry-run to the reference's: the collective bytes per
chip of every (cell, mesh), from both packages' ``run_cell`` JSONs::

    PYTHONPATH=src python scripts/dryrun_parity.py --mesh both
    PYTHONPATH=src python scripts/dryrun_parity.py --arch qwen3-8b \\
        --shape decode_32k --mesh single

The reference's dry-run (``python -m repro.launch.dryrun``, JAX on 512
forced host devices: its ``XLA_FLAGS`` must come before any JAX import)
runs in a process of its own, the port's (``python -m
repro_torch.launch.dryrun``) in one process per architecture, up to
``--jobs`` at a time. The JSONs go under ``--out`` (``ref/`` and
``port/``). One row per (cell, mesh): both ``collective_bytes_per_chip``
in MB, their ratio, both per-kind breakdowns (``ag`` all-gather, ``ar``
all-reduce, ``rs`` reduce-scatter, ``a2a`` all-to-all, ``cp``
collective-permute), both bottlenecks (the reference's under its TPU
constants, the port's under the H100's) and the port's
``replicated_ops``. A cell whose JSON carries no
``collective_caveat`` must come within +-20 % of the reference (or both
be 0): the exit code is 1 when one does not, or when a run failed.
Beside the collective ratio each row reports the port / reference ratios
of ``hlo_flops_per_chip`` and ``hlo_bytes_per_chip`` (``flops``,
``bytes``): a report only, with no gate; the last summary line counts
the pairs outside 20 % on bytes. ``--markdown`` prints the table as
Markdown. The port's wall time is printed last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ARCH_IDS, all_cells  # noqa: E402

TOLERANCE = 0.20
KINDS = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
         "all-to-all": "a2a", "collective-permute": "cp"}


def within(ref: float, port: float) -> bool:
    """The gate: within +-20 % of the reference, or both 0."""
    if ref == 0:
        return port == 0
    return abs(port / ref - 1.0) <= TOLERANCE


def _runs(archs, shape, meshes, out):
    """(label, argv) of the reference's run and one port run per arch."""
    mesh = "both" if len(meshes) == 2 else meshes[0]
    sel = ["--mesh", mesh] + (["--shape", shape] if shape else [])
    ref = [sys.executable, "-m", "repro.launch.dryrun", *sel,
           "--out", os.path.join(out, "ref")]
    for a in archs:
        ref += ["--arch", a]
    runs = [("ref", ref)]
    for a in archs:
        runs.append((a, [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", a, *sel, "--out",
                         os.path.join(out, "port")]))
    return runs


def run_all(runs, jobs: int, log_dir: str) -> tuple[dict, float]:
    """Run the commands, ``jobs`` at a time -> ({label: exit code}, the
    port runs' wall seconds, first start to last end)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    os.makedirs(log_dir, exist_ok=True)
    pending, active, rcs = list(runs), {}, {}
    t_port = [None, None]
    while pending or active:
        while pending and len(active) < jobs:
            label, argv = pending.pop(0)
            log = open(os.path.join(log_dir, f"{label}.log"), "w")
            if label != "ref" and t_port[0] is None:
                t_port[0] = time.perf_counter()
            active[label] = (subprocess.Popen(argv, stdout=log,
                                              stderr=subprocess.STDOUT,
                                              env=env, cwd=ROOT), log)
        for label, (proc, log) in list(active.items()):
            if proc.poll() is not None:
                log.close()
                rcs[label] = proc.returncode
                del active[label]
                if label != "ref":
                    t_port[1] = time.perf_counter()
        time.sleep(0.2)
    return rcs, (t_port[1] - t_port[0]) if t_port[0] else 0.0


def _detail(r: dict) -> str:
    return " ".join(f"{KINDS[k]}={v / 1e6:.4g}"
                    for k, v in r["collective_detail"].items() if v) or "-"


def _ratio(ref: float, port: float) -> float:
    return (port / ref) if ref else (1.0 if port == 0 else float("inf"))


def table(cells, meshes, out) -> tuple[list[dict], int]:
    """One row per (cell, mesh) -> (rows, count of gate failures)."""
    rows, bad = [], 0
    for cell in cells:
        for mesh in meshes:
            name = f"{cell.arch}__{cell.shape}__{mesh}.json"
            paths = [os.path.join(out, side, name) for side in ("ref", "port")]
            if not all(os.path.exists(p) for p in paths):
                rows.append({"cell": cell.name, "mesh": mesh,
                             "missing": True})
                bad += 1
                continue
            with open(paths[0]) as f:
                ref = json.load(f)
            with open(paths[1]) as f:
                port = json.load(f)
            a = ref["collective_bytes_per_chip"]
            b = port["collective_bytes_per_chip"]
            caveat = port.get("collective_caveat", "")
            ok = within(a, b)
            if not ok and not caveat:
                bad += 1
            rows.append({
                "cell": cell.name, "mesh": mesh, "ref_mb": a / 1e6,
                "port_mb": b / 1e6,
                "ratio": _ratio(a, b),
                "flops": _ratio(ref["hlo_flops_per_chip"],
                                port["hlo_flops_per_chip"]),
                "bytes": _ratio(ref["hlo_bytes_per_chip"],
                                port["hlo_bytes_per_chip"]),
                "ref_detail": _detail(ref), "port_detail": _detail(port),
                "ref_bound": ref["bottleneck"],
                "port_bound": port["bottleneck"],
                "replicated": ",".join(port.get("replicated_ops", [])) or "-",
                "ok": ok, "caveat": caveat})
    return rows, bad


def show(rows, markdown: bool) -> None:
    head = ["cell", "mesh", "ref MB", "port MB", "port/ref", "flops",
            "bytes", "ref kinds", "port kinds", "ref bound", "port bound",
            "replicated", "gate"]
    if markdown:
        print("| " + " | ".join(head) + " |")
        print("|" + "---|" * len(head))
    for r in rows:
        if r.get("missing"):
            cols = [r["cell"], r["mesh"]] + ["missing"] * (len(head) - 2)
        else:
            gate = ("ok" if r["ok"] else "caveat" if r["caveat"]
                    else "OUTSIDE")
            cols = [r["cell"], r["mesh"], f"{r['ref_mb']:.6g}",
                    f"{r['port_mb']:.6g}", f"{r['ratio']:.3f}",
                    f"{r['flops']:.3f}", f"{r['bytes']:.3f}",
                    r["ref_detail"], r["port_detail"], r["ref_bound"],
                    r["port_bound"], r["replicated"], gate]
        print(("| " + " | ".join(cols) + " |") if markdown
              else "  ".join(str(c) for c in cols))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable); default: all")
    ap.add_argument("--shape", default=None, help="only this shape cell")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun_parity")
    ap.add_argument("--jobs", type=int, default=4,
                    help="processes at a time (the reference's is one)")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    archs = args.arch or list(ARCH_IDS)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [c for c in all_cells(archs)
             if args.shape is None or c.shape == args.shape]
    out = os.path.abspath(args.out)
    rcs, port_s = run_all(_runs(archs, args.shape, meshes, out), args.jobs,
                          os.path.join(out, "logs"))
    rows, bad = table(cells, meshes, out)
    show(rows, args.markdown)
    failed = sorted(k for k, rc in rcs.items() if rc)
    n_cav = sum(1 for r in rows if not r.get("missing") and r["caveat"])
    off = [f"{r['cell']}/{r['mesh']} x{r['bytes']:.3f}" for r in rows
           if not r.get("missing") and not within(1.0, r["bytes"])]
    print(f"# {len(rows)} (cell, mesh) pairs; {bad} outside +-20 % without "
          f"a caveat; {n_cav} with a caveat; failed runs: "
          f"{', '.join(failed) or 'none'}")
    print(f"# bytes per chip outside +-20 % (report only): {len(off)}"
          + (": " + ", ".join(off) if off else ""))
    print(f"# port dry-run wall time: {port_s:.1f} s "
          f"({len(archs)} processes, {args.jobs} at a time)")
    return 1 if bad or failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Holds the port's dry-run to the reference's: the collective bytes,
flops and bytes accessed per chip of every (cell, mesh), from both
packages' ``run_cell`` JSONs::

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
``replicated_ops``; then the port / reference ratios of
``hlo_flops_per_chip`` and ``hlo_bytes_per_chip`` (``flops``, ``bytes``:
the reference's are XLA:CPU's ``cost_analysis()``, the port's its model of
it, :mod:`repro_torch.roofline.cost_model`) and of
``memory_analysis.temp_size_in_bytes`` (``temp``: a report only, the
port's live-storage peak against XLA's buffer assignment).

Each of the three gated ratios must come within +-20 % (or both be 0)
unless the port's JSON carries a caveat for it (``collective_caveat``,
``flops_caveat``, ``bytes_caveat``) that names the ratio ("x<ratio>") it
explains: then the ratio must be that one, within 1 %. The exit code is 1
when a pair fails a gate, or when a run failed. ``--markdown`` prints the
table as Markdown. The port's wall time is printed last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def gate(ref: float, port: float, caveat: str) -> str:
    """``ok``, ``caveat`` (outside, by the ratio the caveat names) or
    ``OUTSIDE``."""
    if not caveat:
        return "ok" if within(ref, port) else "OUTSIDE"
    named = re.search(r"x(\d+(?:\.\d+)?)", caveat)
    ratio = _ratio(ref, port)
    if named and abs(ratio / float(named.group(1)) - 1.0) <= 0.01:
        return "caveat"
    return "OUTSIDE"


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
            gates = {k: gate(ref[key], port[key], port.get(f"{k}_caveat", ""))
                     for k, key in (("collective", "collective_bytes_per_chip"),
                                    ("flops", "hlo_flops_per_chip"),
                                    ("bytes", "hlo_bytes_per_chip"))}
            failed = [k for k, g in gates.items() if g == "OUTSIDE"]
            bad += bool(failed)
            temp = [r["memory_analysis"].get("temp_size_in_bytes", 0)
                    for r in (ref, port)]
            rows.append({
                "cell": cell.name, "mesh": mesh, "ref_mb": a / 1e6,
                "port_mb": b / 1e6,
                "ratio": _ratio(a, b),
                "flops": _ratio(ref["hlo_flops_per_chip"],
                                port["hlo_flops_per_chip"]),
                "bytes": _ratio(ref["hlo_bytes_per_chip"],
                                port["hlo_bytes_per_chip"]),
                "temp": _ratio(*temp),
                "ref_detail": _detail(ref), "port_detail": _detail(port),
                "ref_bound": ref["bottleneck"],
                "port_bound": port["bottleneck"],
                "replicated": ",".join(port.get("replicated_ops", [])) or "-",
                "failed": failed,
                "caveats": [k for k, g in gates.items() if g == "caveat"]})
    return rows, bad


def show(rows, markdown: bool) -> None:
    head = ["cell", "mesh", "ref MB", "port MB", "port/ref", "flops",
            "bytes", "temp", "ref kinds", "port kinds", "ref bound",
            "port bound", "replicated", "gate"]
    if markdown:
        print("| " + " | ".join(head) + " |")
        print("|" + "---|" * len(head))
    for r in rows:
        if r.get("missing"):
            cols = [r["cell"], r["mesh"]] + ["missing"] * (len(head) - 2)
        else:
            state = ("OUTSIDE: " + ",".join(r["failed"]) if r["failed"]
                     else "caveat: " + ",".join(r["caveats"])
                     if r["caveats"] else "ok")
            cols = [r["cell"], r["mesh"], f"{r['ref_mb']:.6g}",
                    f"{r['port_mb']:.6g}", f"{r['ratio']:.3f}",
                    f"{r['flops']:.3f}", f"{r['bytes']:.3f}",
                    f"{r['temp']:.3f}", r["ref_detail"], r["port_detail"],
                    r["ref_bound"], r["port_bound"], r["replicated"], state]
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
    done = [r for r in rows if not r.get("missing")]
    n_cav = sum(1 for r in done if r["caveats"])
    print(f"# {len(rows)} (cell, mesh) pairs; {bad} outside +-20 % without "
          f"a caveat; {n_cav} with a caveat; failed runs: "
          f"{', '.join(failed) or 'none'}")
    for key in ("ratio", "flops", "bytes"):
        worst = sorted(done, key=lambda r: abs(r[key] - 1.0))[-1:]
        print(f"# {'collective' if key == 'ratio' else key}: "
              f"{sum(within(1.0, r[key]) for r in done)} of {len(done)} "
              f"within +-20 %" + "".join(
                  f"; farthest {r['cell']}/{r['mesh']} x{r[key]:.3f}"
                  for r in worst))
    print(f"# port dry-run wall time: {port_s:.1f} s "
          f"({len(archs)} processes, {args.jobs} at a time)")
    return 1 if bad or failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the workload's ``config`` is
``perfbench/configs/<config>.json`` (its ``system`` names the module in
``perfbench/systems/`` that drives the program), its ``traffic`` is
``perfbench/traffic/<traffic>.json``, and every metric ``<name>`` is read
by ``perfbench/metrics/<name>.py``'s ``read(ctx)`` (or, for
``<base>.<suffix>``, by ``<base>.py``). A cell, a traffic mix or a metric
is added by new files and entries alone, as long as its traffic's
``entry`` and its configuration's values are ones that a driver's tables
name: a driver refuses any other (``perfbench/systems/__init__.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_STREAM = 6


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str, root: str = ROOT):
    """``(workload entry, configuration, traffic, config file's JSON)``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    wl = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    cfg = _load_json(root, cfg_entry["file"])
    traffic = _load_json(root, "perfbench", "traffic",
                         wl["traffic"] + ".json")
    return wl, cfg_entry, cfg, traffic


def metric_reader(name: str, root: str = ROOT):
    """The ``read(ctx)`` of ``perfbench/metrics/<name>.py``; for a name
    ``<base>.<suffix>`` without a file of its own, the reader of
    ``<base>.py`` that the metrics of every suffix share."""
    base = os.path.join(root, "perfbench", "metrics")
    path = os.path.join(base, name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(base, name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def system_class(cfg: dict):
    return importlib.import_module(f"perfbench.systems.{cfg['system']}"
                                   ).System


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _device_info(dev, chips: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _pick(n_done: int, n_pick: int, seed: int) -> np.ndarray:
    """The window steps the reference checks: ``n_pick`` drawn from the
    seed, always with the first and the last."""
    rng = np.random.default_rng([int(seed) % 2**63, CHECK_STREAM])
    if n_done <= n_pick:
        return np.arange(n_done)
    mid = rng.choice(np.arange(1, n_done - 1), n_pick - 2, replace=False)
    return np.sort(np.concatenate([[0, n_done - 1], mid]))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             dev, t_start: float, root: str = ROOT, control: bool = False,
             overrides: dict | None = None) -> tuple[dict, list]:
    """One run. Returns ``(result line, check lines)``. ``overrides``
    replace configuration and traffic keys (the CPU tests' small sizes);
    ``control`` runs the program in the precision below the one the
    configuration states."""
    import torch

    manifest = load_manifest(root)
    wl, _, cfg, traffic = find_cell(manifest, workload, root)
    cfg = {**cfg, **(overrides or {}).get("config", {})}
    traffic = {**traffic, **(overrides or {}).get("traffic", {})}
    chips = int(wl["chips"])
    system = system_class(cfg)(cfg, traffic, seed, dev, control=control)
    system.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    label = torch.profiler.record_function
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    results, lat = {}, []
    with label("bench.window"):
        w0 = time.perf_counter()
        end = w0 + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            results[i] = system.run_once(i, label)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            i += 1
            if t1 >= end:
                break
        window_s = time.perf_counter() - w0
    phases = {"setup_s": setup_s, "window_s": window_s, "steps": i}
    if lat:
        for q in (50, 95, 99, 100):
            phases[f"lat_p{q}_ms"] = float(np.percentile(lat, q)) * 1e3
    summary = None
    t0 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
        from .trace import summarize

        summary = summarize(prof)
        prof = None
        phases["trace_read_s"] = time.perf_counter() - t0
    device = _device_info(dev, chips)
    n_steps = i
    per_step = system.queries_per_step()

    t0 = time.perf_counter()
    pick = _pick(n_steps, int(cfg["check"]["batches"]), seed)
    numbers = system.check(results, pick)
    phases["check_s"] = time.perf_counter() - t0
    limits = cfg["check"]["limits"]
    check_lines, correct = [], n_steps > 0
    for name, value in numbers.items():
        lim = limits.get(name)
        ok = lim is not None and math.isfinite(value) and value <= lim
        correct = correct and ok
        check_lines.append((name, value, lim, ok))

    ctx = {"workload": workload, "traffic": traffic, "config": cfg,
           "setup_s": setup_s, "window_s": window_s, "n_steps": n_steps,
           "queries": n_steps * per_step, "latencies_s": lat,
           "trace": summary, "work": None}
    if trace:
        t0 = time.perf_counter()
        ctx["work"] = system.work(n_steps)
        phases["work_s"] = time.perf_counter() - t0
    metrics = {}
    for m in cell_metrics(manifest, workload, trace):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    line = {"correct": bool(correct), "attempted": n_steps * per_step,
            "failed": 0, "metrics": metrics, "device": device}
    if summary is not None:
        line["breakdown"] = summary.breakdown()
    # a number that is not finite (a stage the check could not follow) is
    # written as the largest double, so that the line stays plain JSON
    line["checks"] = {name: {"value": value if math.isfinite(value)
                             else 1.7976931348623157e308, "limit": lim}
                      for name, value, lim, _ in check_lines}
    print("perfbench: " + " ".join(f"{k}={v:.6g}" for k, v in
                                    phases.items()), file=sys.stderr)
    return line, check_lines


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program one precision below the "
                         "configuration's (the check must fail)")
    args = ap.parse_args(argv)

    import torch

    manifest = load_manifest()
    wl = find_cell(manifest, args.workload)[0]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(wl["chips"]):
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found {found} (no CPU fallback)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line, checks = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), dev=dev, t_start=t_start,
                            control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}, which the port may not "
              "use", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, value, lim, ok in checks:
        print(f"check {name} = {value!r} limit {lim!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

#!/usr/bin/env python3
"""Where a recsys training step's time goes on the card::

    python3 scripts/recsys_train_profile.py

For each of ``chip_smoke.py`` path I's runs (the four recsys configurations
at ``make_config()`` widths, DLRM's tables capped at 2,000,000 rows, DLRM
one-hot and multi-hot; batch 65,536, ``adamw(1e-3)``) it makes the model
and step 0's batch, takes one warm-up step of ``recsys_train_step``, then
profiles two more with ``torch.profiler`` (CPU and CUDA activities) and
prints per step: the host wall time, the device time summed over kernels,
the device's idle share (1 - device time / wall time), and the kernels with
the most device time, by name.

For the runs whose embeddings are one-hot gathers (DLRM one-hot, AutoInt)
it also times the step with ``models.recsys.lookup`` replaced by
``index_select`` (whose backward is ``index_add_``; the advanced indexing
the port uses has a sorting ``index_put_`` as backward), parent order
(lookup, index_select, index_select, lookup), and the largest gradient
difference between the two relative to each tensor's largest value. The
replacement is an experiment of this script only.

One JSON line per run and the card's name and power limit. Needs a CUDA
card and ``nvcc`` (DLRM multi-hot builds the ``embed_bag`` kernel).
"""

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs.common import (  # noqa: E402
    recsys_loss_and_grads, recsys_train_step)
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOP = 12


def index_select_lookup(tables, ids):
    """``lookup`` by ``index_select``: the same rows, another backward."""
    return torch.stack([tables[f"table_{i}"].index_select(0, ids[:, i].long())
                        for i in range(ids.shape[1])], dim=1)


def step_ms(model, opt, state, batch, reps=3):
    """Median host wall ms of ``reps`` synchronised training steps."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = recsys_train_step(model, opt, state, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), state


def profile_steps(model, opt, state, batch, steps=2):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _, state = recsys_train_step(model, opt, state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key[:90]] = us / 1e3 / steps
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP])
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "kernels": len(kernels), "top_ms": top}, state


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    # the profiler's first start initialises its tracing: not in a step
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    for seed, (name, cls, cfg, mh) in enumerate(chip_smoke.train_runs()):
        host = chip_smoke.train_host_batches(cfg, mh)[0]
        model = cls(cfg, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        opt = adamw(1e-3)
        state = opt.init(dict(model.p))
        _, state = recsys_train_step(model, opt, state, batch)   # warm-up
        prof, state = profile_steps(model, opt, state, batch)
        out = {"run": name, "batch": chip_smoke.I_BATCH, "card": card,
               "profile": prof}
        if mh == 1 and cls in (rs.DLRM, rs.AutoInt):
            real = rs.lookup
            times = {"lookup": [], "index_select": []}
            for which in ("lookup", "index_select", "index_select", "lookup"):
                rs.lookup = real if which == "lookup" else index_select_lookup
                try:
                    ms, state = step_ms(model, opt, state, batch)
                finally:
                    rs.lookup = real
                times[which].append(ms)
            _, g_a = recsys_loss_and_grads(model, batch)
            rs.lookup = index_select_lookup
            try:
                _, g_b = recsys_loss_and_grads(model, batch)
            finally:
                rs.lookup = real
            rel = max(float((g_a[n] - g_b[n]).abs().max())
                      / (float(g_a[n].abs().max()) or 1.0) for n in g_a)
            del g_a, g_b
            out["lookup_vs_index_select_step_ms"] = times
            out["index_select_grad_max_rel_diff"] = rel
        print(json.dumps(out), flush=True)
        del model, opt, state, batch
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

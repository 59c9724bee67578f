#!/usr/bin/env python3
"""Where the LM family's serving and training time goes on the card::

    python3 scripts/lm_profile.py

For each configuration of ``chip_smoke.py`` path J (qwen3-8b and
qwen2-moe-a2.7b at ``make_config()`` widths in bf16, weights from a seed,
8 prompts of 2,048 tokens from ``lm_batch``) it takes one warm-up prefill
and decode step, then profiles one ``prefill`` and 4 greedy
``decode_step``s with ``torch.profiler`` (CPU and CUDA activities); then
the same for 2 training steps of path J's ~100M fp32 config
(``loss_fn``, the backward, ``adamw(3e-4)``). For each phase it prints the
host wall time, the device time summed over kernels, the device's idle
share (1 - device time / wall time), the kernel launches, and the kernels
with the most device time, by name.

One JSON line per phase and the card's name and power limit. Needs a CUDA
card.
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

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOP = 12
DECODE_STEPS = 4


def profiled(fn, steps):
    """Run ``fn()`` ``steps`` times under the profiler; per-step wall ms,
    device ms, idle share, launches and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key[:90]] = us / 1e3 / steps
            launches += ev.count
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP])
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "launches": launches / steps, "top_ms": top}


def serve(dev, arch, seed, card):
    cfg = get_arch(arch).make_config()
    model = tf.Transformer(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    toks = torch.as_tensor(lm_batch(cfg.vocab, chip_smoke.J_BATCH,
                                    chip_smoke.J_PROMPT, step=0)[0], device=dev)
    state = {}

    def prefill():
        state.pop("cache", None)
        logits, state["cache"] = tf.prefill(model, toks, cfg)
        state["nxt"] = logits.argmax(-1).to(torch.int32)

    def decode():
        logits, state["cache"] = tf.decode_step(model, state["cache"],
                                                state["nxt"], cfg)
        state["nxt"] = logits.argmax(-1).to(torch.int32)

    with torch.inference_mode():
        prefill()
        decode()                                  # warm-up
        for phase, fn, steps in (("prefill", prefill, 1),
                                 ("decode", decode, DECODE_STEPS)):
            out = {"arch": arch, "phase": phase, "card": card,
                   "profile": profiled(fn, steps)}
            print(json.dumps(out), flush=True)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()


def train(dev, card):
    cfg = chip_smoke.lm_train_config()
    model = tf.Transformer(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw(chip_smoke.J_TRAIN["lr"])
    state = {"opt": opt.init(params)}
    toks, labels = (torch.as_tensor(a, device=dev) for a in lm_batch(
        cfg.vocab, chip_smoke.J_TRAIN["batch"], chip_smoke.J_TRAIN["seq_len"],
        step=0))

    def step():
        loss, _ = tf.loss_fn(model, toks, labels, cfg)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _, state["opt"] = opt.update(grads, state["opt"], params)

    step()                                        # warm-up
    out = {"arch": cfg.name, "phase": "train_step", "card": card,
           "profile": profiled(step, 2)}
    print(json.dumps(out), flush=True)


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    # the profiler's first start initialises its tracing: not in a phase
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    for seed, arch in enumerate(chip_smoke.J_ARCHS):
        serve(dev, arch, seed, card)
    train(dev, card)


if __name__ == "__main__":
    main()

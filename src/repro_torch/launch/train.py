"""End-to-end LM training driver with checkpoint/restart fault tolerance
(port of :mod:`repro.launch.train`).

Runs any LM arch (full or smoke config) on the card, or on the CPU with
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir runs/run1

* auto-resume from the newest complete checkpoint under ``--ckpt-dir``
  into the live model and optimizer state (kill it, rerun, it continues
  from the last checkpointed step); the checkpoint directory has the
  reference's layout, so either package resumes the other's run;
* SIGTERM (preemption) checkpoints at the end of the step in progress, and
  the driver returns;
* the batches are stateless in (seed, step) (``lm_batch``, bit-identical
  to the reference's), so a resumed run sees the batches the
  uninterrupted run saw.

The step is ``optim.accumulate_gradients`` over
``models.transformer.loss_fn``, then ``adamw(lr)``, which updates the
parameters and the moments in place.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.manager import flatten
from ..configs import get_arch
from ..data.lm import lm_batch
from ..kernels.common import resolve_device
from ..models import transformer as tf
from ..optim import accumulate_gradients, adamw
from ..optim.adamw import AdamWState
from ..runtime.fault import FaultCoordinator

__all__ = ["train_lm", "checkpoint_tree", "main"]


def checkpoint_tree(params, opt_state: AdamWState) -> dict:
    """The reference's checkpoint tree, ``{"params": ..., "opt_state":
    AdamWState(step, mu, nu)}``, with the parameters and moments nested
    by their dot-joined names as the reference's pytrees are."""
    return {"params": tf._tree(params),
            "opt_state": AdamWState(step=opt_state.step,
                                    mu=tf._tree(opt_state.mu),
                                    nu=tf._tree(opt_state.nu))}


def train_lm(
    cfg: tf.TransformerConfig,
    *,
    steps: int,
    batch: int,
    seq_len: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    n_micro: int = 1,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    fault: FaultCoordinator | None = None,
    device=None,
):
    """Train; returns (model, losses). Resumes from ckpt_dir if present."""
    dev = resolve_device(device)
    opt = adamw(lr)
    model = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    start_step = 0
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None and manager.latest_step() is not None:
        live = checkpoint_tree(params, opt_state)
        tree, step, _ = manager.restore(live)
        with torch.no_grad():
            for dst, src in zip(flatten(live), flatten(tree)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        opt_state = opt_state._replace(step=tree["opt_state"].step)
        del tree
        start_step = step
        print(f"[train] resumed from step {step}", flush=True)

    def lf(p, b):
        return tf.loss_fn(p, b["tokens"], b["labels"], cfg)

    losses = []
    preempt_requested = []
    if fault is not None:
        fault.install_preemption_hook(lambda: preempt_requested.append(True))

    t0 = time.time()
    for step in range(start_step, steps):
        tokens, labels = lm_batch(
            cfg.vocab, batch, seq_len, step=step, seed=seed
        )
        loss, grads, _ = accumulate_gradients(
            lf, params, {"tokens": torch.as_tensor(tokens, device=dev),
                         "labels": torch.as_tensor(labels, device=dev)},
            n_micro)
        params, opt_state = opt.update(grads, opt_state, params)
        del grads
        losses.append(float(loss))
        if step % log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {step} loss {losses[-1]:.4f} ({dt:.1f}s)",
                  flush=True)
        must_ckpt = manager is not None and (
            (step + 1) % ckpt_every == 0 or preempt_requested
        )
        if must_ckpt:
            manager.save(step + 1, checkpoint_tree(params, opt_state),
                         extra={"losses_tail": losses[-5:]})
            if preempt_requested:
                print(f"[train] preempted -> checkpointed at {step + 1}, "
                      f"exiting", flush=True)
                return model, losses
    if manager is not None:
        manager.save(steps, checkpoint_tree(params, opt_state),
                     extra={"losses_tail": losses[-5:]})
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    cfg = mod.make_smoke_config() if args.smoke else mod.make_config()
    if not isinstance(cfg, tf.TransformerConfig):
        raise SystemExit(f"{args.arch} is not an LM arch; use its own example")
    fault = FaultCoordinator()
    _, losses = train_lm(
        cfg, steps=args.steps, batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        n_micro=args.micro, lr=args.lr, fault=fault, device=args.device,
    )
    print(f"[train] done. first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}", flush=True)


if __name__ == "__main__":
    main()

"""Train a ~100M-param qwen3-style LM for a few hundred steps with
checkpoint/restart (port of ``examples/train_lm.py``; kill it mid-run and
rerun it: it resumes)::

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu] \
        [--steps 200] [--ckpt-dir DIR]

The checkpoints go under ``DIR`` (default ``repro_torch_train_lm`` in the
temporary directory). The run ends with the reference's assertion: the
last loss is below the first.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..launch.train import train_lm
from ..models.transformer import TransformerConfig

__all__ = ["CONFIG", "run", "main"]

# ~100M params: 8 layers x d512 x ff2048, 32k vocab (fp32)
CONFIG = TransformerConfig(
    name="qwen3-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
    d_head=64, d_ff=2048, vocab=32_000, qk_norm=True,
    attn_q_chunk=128, attn_kv_chunk=128, max_seq_len=512,
)


def run(cfg: TransformerConfig = CONFIG, *, steps: int = 200,
        batch: int = 8, seq_len: int = 256, ckpt_dir: str | None = None,
        ckpt_every: int = 50, lr: float = 3e-4, device=None):
    """The example's run; returns ``(model, losses)`` after its
    assertion."""
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    model, losses = train_lm(
        cfg, steps=steps, batch=batch, seq_len=seq_len, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, lr=lr, device=device,
    )
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}")
    return model, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(steps=args.steps, ckpt_dir=args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Deterministic synthetic token streams for LM training (port of
:mod:`repro.data.lm`).

Pure numpy, copied rather than imported so the port needs nothing of the
JAX package: for the same ``(seed, step, shard)`` it returns arrays
bit-identical to the reference's. Zipf-distributed unigrams with a
short-range bigram mixture so the loss has learnable structure (a
transformer should beat the unigram entropy quickly). Batches are derived
from ``(seed, step, shard)`` counters — no state, so any worker can
deterministically regenerate any batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream", "lm_batch"]


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -alpha
    return p / p.sum()


def lm_batch(
    vocab: int,
    batch: int,
    seq_len: int,
    *,
    step: int,
    shard: int = 0,
    n_shards: int = 1,
    seed: int = 0,
):
    """One (tokens, labels) LM batch, deterministic in (seed, step, shard).

    ``labels`` are ``tokens`` shifted left (next-token prediction), with the
    final position masked via label ``-1``.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, n_shards])
    )
    p = _zipf_probs(vocab)
    toks = rng.choice(vocab, size=(batch, seq_len + 1), p=p)
    # Bigram structure: with prob 0.35, token t+1 = f(token t) for a fixed
    # random permutation f — gives the model something beyond unigram stats.
    perm_rng = np.random.default_rng(seed)  # shared across steps/shards
    f = perm_rng.permutation(vocab)
    follow = rng.random((batch, seq_len)) < 0.35
    nxt = f[toks[:, :-1]]
    toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return tokens, labels


@dataclasses.dataclass
class TokenStream:
    """Iterator facade over :func:`lm_batch` for the training loop."""

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1
    step: int = 0

    def __iter__(self):
        return self

    def __next__(self):
        out = lm_batch(
            self.vocab,
            self.batch,
            self.seq_len,
            step=self.step,
            shard=self.shard,
            n_shards=self.n_shards,
            seed=self.seed,
        )
        self.step += 1
        return out

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

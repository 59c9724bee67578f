"""Synthetic click-log generator for the recsys architectures (port of
:mod:`repro.data.recsys_data`).

Pure numpy, copied rather than imported so the port needs nothing of the
JAX package: for the same ``(seed, step, shard)`` it returns arrays
bit-identical to the reference's. Matches the DLRM / Criteo shape
conventions: ``n_dense`` continuous features, ``n_sparse`` categorical
fields with per-field vocabularies (log-uniform ids — the head of each
vocabulary is hot, like real ID distributions), optional multi-hot bags,
and labels produced by a *hidden* bilinear model so CTR training has
signal. Sequence batches (user history + target item) serve BST and MIND.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RecsysBatchConfig", "click_batch", "history_batch"]


@dataclasses.dataclass(frozen=True)
class RecsysBatchConfig:
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = (100_000,) * 26
    multi_hot: int = 1            # ids per field (1 = one-hot lookup)
    seed: int = 0


def _log_uniform(rng, vocab, size):
    """Head-heavy categorical ids: floor(exp(U * ln(vocab)))."""
    u = rng.random(size)
    ids = np.exp(u * np.log(vocab)).astype(np.int64) - 1
    return np.clip(ids, 0, vocab - 1)


def click_batch(cfg: RecsysBatchConfig, batch: int, *, step: int, shard: int = 0):
    """One CTR batch: (dense (B, n_dense) f32, sparse (B, F, M) i32, y (B,))."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
    dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    f = len(cfg.vocab_sizes)
    sparse = np.stack(
        [_log_uniform(rng, v, (batch, cfg.multi_hot)) for v in cfg.vocab_sizes],
        axis=1,
    ).astype(np.int32)                                   # (B, F, M)
    # Hidden model: dense linear + per-field hash bucket affinity.
    w_rng = np.random.default_rng(cfg.seed)              # static across steps
    wd = w_rng.normal(size=(cfg.n_dense,)).astype(np.float32)
    field_bias = w_rng.normal(size=(f, 64)).astype(np.float32)
    logits = dense @ wd
    for i in range(f):
        logits += field_bias[i, sparse[:, i, 0] % 64] / np.sqrt(f)
    y = (rng.random(batch) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return dense, sparse, y


def history_batch(
    n_items: int,
    batch: int,
    hist_len: int,
    *,
    step: int,
    shard: int = 0,
    seed: int = 0,
):
    """Sequence batch for BST / MIND: (hist (B, L) i32, target (B,) i32, y (B,)).

    Positive targets continue the user's dominant "interest" (a hidden item
    cluster); negatives are sampled uniformly — so attention over history is
    genuinely predictive.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard, 7]))
    n_clusters = 50
    # cluster(item) = item % n_clusters — cheap, known to the generator only
    item_cluster = np.arange(n_items) % n_clusters
    user_pref = rng.integers(0, n_clusters, batch)
    # 70% of history from the user's preferred cluster, rest random.
    from_pref = rng.random((batch, hist_len)) < 0.7
    rand_items = _log_uniform(rng, n_items, (batch, hist_len))
    # rejection-free: pick random items then map to preferred cluster by
    # re-drawing within cluster via modular shift (cheap, approximately uniform
    # within cluster)
    cluster_items = (rand_items // n_clusters) * n_clusters + user_pref[:, None]
    cluster_items = np.clip(cluster_items, 0, n_items - 1)
    hist = np.where(from_pref, cluster_items, rand_items).astype(np.int32)

    pos = rng.random(batch) < 0.5
    pos_target = np.clip(
        (_log_uniform(rng, n_items, batch) // n_clusters) * n_clusters + user_pref,
        0, n_items - 1,
    )
    neg_target = _log_uniform(rng, n_items, batch)
    target = np.where(pos, pos_target, neg_target).astype(np.int32)
    # label: does the target's cluster match the user preference?
    y = (item_cluster[target] == user_pref).astype(np.float32)
    return hist, target, y

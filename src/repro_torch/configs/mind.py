"""mind [arXiv:1904.08030] — Multi-Interest Network with Dynamic routing
(port of :mod:`repro.configs.mind`).

Item embedding dim 64 (1M items), 4 interest capsules, 3 dynamic-routing
iterations, history length 50. The paper-representative architecture: its
serving step scores a query against candidates under per-request interest
weights — Dynamic Vector Score Aggregation with s = 4 sources of evidence;
``retrieval_cand`` is served as a batched dot
(:func:`repro_torch.configs.common.recsys_retrieval_step`) and through the
cluster-pruned index (``python -m repro_torch.examples.recsys_retrieval``).
"""

from __future__ import annotations

from ..models.recsys import MINDConfig

ARCH_ID = "mind"


def make_config() -> MINDConfig:
    return MINDConfig(
        name=ARCH_ID,
        n_items=1_000_448,            # 1M padded to a 512 multiple
        embed_dim=64, n_interests=4, capsule_iters=3, hist_len=50,
    )


def make_smoke_config() -> MINDConfig:
    return MINDConfig(
        name=ARCH_ID + "-smoke", n_items=3_000, embed_dim=32, n_interests=4,
        capsule_iters=3, hist_len=20,
    )

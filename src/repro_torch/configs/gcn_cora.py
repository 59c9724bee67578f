"""gcn-cora [arXiv:1609.02907] (port of :mod:`repro.configs.gcn_cora`):
a 2-layer GCN, d_hidden 16, symmetric normalisation.

The reference's four shape units (``cells()``: Cora full batch, a
Reddit-scale sampled minibatch, ogbn-products full batch, batched
molecule graphs) come with the dry-run slice; ``chip_smoke.py`` path L
trains the four shapes on the card.
"""

from __future__ import annotations

from ..models.gnn import GCNConfig

ARCH_ID = "gcn-cora"


def make_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID, n_layers=2, d_in=1433, d_hidden=16,
                     n_classes=7, aggregator="mean", norm="sym")


def make_smoke_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_in=64,
                     d_hidden=16, n_classes=7)

"""gcn-cora [arXiv:1609.02907] (port of :mod:`repro.configs.gcn_cora`):
a 2-layer GCN, d_hidden 16, symmetric normalisation.

``cells()`` are the reference's four shape units (Cora full batch, a
Reddit-scale sampled minibatch, ogbn-products full batch, batched
molecule graphs); ``chip_smoke.py`` path L trains the four shapes on the
card.
"""

from __future__ import annotations

from ..models.gnn import GCNConfig
from .common import gnn_full_cell, gnn_minibatch_cell, gnn_molecule_cell

ARCH_ID = "gcn-cora"


def make_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID, n_layers=2, d_in=1433, d_hidden=16,
                     n_classes=7, aggregator="mean", norm="sym")


def make_smoke_config() -> GCNConfig:
    return GCNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_in=64,
                     d_hidden=16, n_classes=7)


def cells():
    return [
        gnn_full_cell(
            ARCH_ID, make_config(), n_nodes=2708, n_edges=10_556,
            shape_name="full_graph_sm"),
        gnn_minibatch_cell(
            ARCH_ID,
            GCNConfig(name=ARCH_ID, n_layers=2, d_in=602, d_hidden=16,
                      n_classes=41),
            batch_nodes=1024, fanouts=(15, 10), shape_name="minibatch_lg",
        ),
        gnn_full_cell(
            ARCH_ID,
            GCNConfig(name=ARCH_ID, n_layers=2, d_in=100, d_hidden=16,
                      n_classes=47),
            n_nodes=2_449_029, n_edges=61_859_140,
            shape_name="ogb_products",
        ),
        gnn_molecule_cell(
            ARCH_ID,
            GCNConfig(name=ARCH_ID, n_layers=2, d_in=16, d_hidden=16,
                      n_classes=2, readout="mean"),
            batch=128, nodes_per_graph=30, edges_per_graph=64,
            shape_name="molecule",
        ),
    ]

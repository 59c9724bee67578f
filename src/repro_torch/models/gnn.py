"""GCN (Kipf & Welling) by edge-list message passing (port of
:mod:`repro.models.gnn`).

Symmetric normalisation ``D^-1/2 (A+I) D^-1/2`` is computed from the edge
list; self-loops are a separate diagonal term. Supports full-batch node
classification, sampled-minibatch training on subgraphs from
``repro_torch.data.graphs.sample_khop`` (the same code path on a small
edge list) and batched small graphs with a per-graph mean-pool readout.

Edges may be padded with ``src`` or ``dst = n_nodes``: such an edge gets
coefficient 0 and adds nothing.

The reference's ``jax.ops.segment_sum`` is ``index_add`` here, and its
gather ``h[src]`` is ``index_select`` (whose backward is an ``index_add``,
not a sort). On the card ``index_add`` sums with atomics in no fixed
order, so results are neither bit-equal to the CPU's nor repeatable from
run to run: each aggregated value is a sum of ``deg + 1`` fp32 terms, good
to a few ulps of the sum of their magnitudes. The degrees are sums of
ones, exact in any order.

Memory: a propagation holds the ``(E, d)`` gathered messages, scaled in
place, so one ``(E, d)`` fp32 temporary (24.7 GB for layer 0 at
ogbn-products' 61.9M edges and d = 100). The features take no gradient,
so layer 0's propagation records nothing for the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..kernels.common import resolve_device
from .transformer import matmul32

__all__ = ["GCNConfig", "gcn_init", "gcn_param_specs", "gcn_forward",
           "gcn_forward_layered", "gcn_loss", "graph_readout_loss",
           "sampled_loss", "from_reference_params"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    aggregator: str = "mean"      # paper config tag; sym-norm mean
    norm: str = "sym"
    readout: str | None = None    # None | "mean" (graph-level tasks)
    dtype = torch.float32


def _dims(cfg: GCNConfig):
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return list(zip(dims[:-1], dims[1:]))


def gcn_param_specs(cfg: GCNConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape (all in ``cfg.dtype``), in the
    reference's order: the weights, then the biases."""
    return {
        f"w{i}": tuple(dw) for i, dw in enumerate(_dims(cfg))
    } | {
        f"b{i}": (dw[1],) for i, dw in enumerate(_dims(cfg))
    }


def _leaves(cfg: GCNConfig, values: Mapping[str, torch.Tensor], dev):
    """The parameters as leaf tensors that require grad, on ``dev``."""
    return {name: values[name].to(dev, cfg.dtype).requires_grad_(True)
            for name in gcn_param_specs(cfg)}


def gcn_init(cfg: GCNConfig, generator: torch.Generator | None = None, *,
             device=None) -> dict[str, torch.Tensor]:
    """The reference's rule: biases zero, weights ``N(0, 1/d_in_of_layer)``,
    drawn in sorted name order from ``generator`` (default seed 0 on the
    device). A torch generator cannot replay ``jax.random``: parity runs
    carry the reference's draw by :func:`from_reference_params`."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, shape in sorted(gcn_param_specs(cfg).items()):
        if name.startswith("b"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            w = torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            out[name] = w.mul_((1.0 / shape[0]) ** 0.5).to(dev)
    return _leaves(cfg, out, dev)


def from_reference_params(cfg: GCNConfig, params: Mapping, *,
                          device=None) -> dict[str, torch.Tensor]:
    """The port's parameters holding the reference's ``{w0, b0, w1, b1}``
    (numpy). Raises ``KeyError`` on missing or unexpected names and
    ``ValueError`` on a shape that differs."""
    dev = resolve_device(device)
    specs = gcn_param_specs(cfg)
    if set(params) != set(specs):
        raise KeyError(f"parameters do not match {cfg.name}: missing "
                       f"{sorted(set(specs) - set(params))}, unexpected "
                       f"{sorted(set(params) - set(specs))}")
    values = {}
    for name, shape in specs.items():
        a = np.asarray(params[name])
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        values[name] = torch.tensor(a)
    return _leaves(cfg, values, dev)


def _sym_coeffs(edge_index: torch.Tensor, n_nodes: int):
    """Per-edge 1/sqrt((deg+1)[src] (deg+1)[dst]) + self-loop 1/(deg+1).

    Padded edges (src or dst == n_nodes) contribute zero.
    """
    src, dst = edge_index[0], edge_index[1]
    valid = (src < n_nodes) & (dst < n_nodes)
    ssafe = torch.where(valid, src, 0)
    dsafe = torch.where(valid, dst, 0)
    ones = valid.to(torch.float32)
    deg = torch.zeros(n_nodes, dtype=torch.float32, device=src.device) \
        .index_add_(0, dsafe, ones) + 1.0                     # +1 self loop
    inv_sqrt = torch.rsqrt(deg)
    coeff = torch.where(valid, inv_sqrt[ssafe] * inv_sqrt[dsafe], 0.0)
    return ssafe, dsafe, coeff, 1.0 / deg


def _propagate(h, src, dst, coeff, self_c):
    """Ã h = scatter(coeff * h[src] -> dst) + self_c * h."""
    msg = torch.index_select(h, 0, src).mul_(coeff[:, None])
    return (torch.zeros_like(h).index_add(0, dst, msg)
            + h * self_c[:, None])


def _layer(params, i, agg, cfg):
    return matmul32(agg, params[f"w{i}"]).to(cfg.dtype) + params[f"b{i}"]


def gcn_forward(params, feats, edge_index, cfg: GCNConfig):
    """feats (n, d_in), edge_index (2, e) int (padded rows = n). -> (n, C)."""
    n = feats.shape[0]
    src, dst, coeff, self_c = _sym_coeffs(edge_index, n)
    h = feats.to(cfg.dtype)
    for i, _ in enumerate(_dims(cfg)):
        h = _layer(params, i, _propagate(h, src, dst, coeff, self_c), cfg)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def gcn_forward_layered(params, feats, edge_lists, cfg: GCNConfig):
    """Sampled-minibatch forward: layer ``i`` aggregates over ``edge_lists[i]``.

    ``edge_lists`` is outermost-hop-first (GraphSAGE block convention): the
    first GCN layer pulls hop-K features inward, the last one lands on the
    seed nodes. All node ids are subgraph-local; padded edges use ``n``.
    """
    n = feats.shape[0]
    h = feats.to(cfg.dtype)
    if len(edge_lists) != cfg.n_layers:
        raise ValueError(f"{len(edge_lists)} edge lists for "
                         f"{cfg.n_layers} layers")
    for i, edges in enumerate(edge_lists):
        src, dst, coeff, self_c = _sym_coeffs(edges, n)
        h = _layer(params, i, _propagate(h, src, dst, coeff, self_c), cfg)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def sampled_loss(params, feats, edge_lists, seed_labels, n_seeds: int,
                 cfg: GCNConfig):
    """Minibatch loss on the first ``n_seeds`` (seed) nodes of the subgraph."""
    logits = gcn_forward_layered(params, feats, edge_lists, cfg)[:n_seeds]
    return torch.mean(_nll(logits, seed_labels))


def gcn_loss(params, feats, edge_index, labels, mask, cfg: GCNConfig):
    """Masked node-classification cross-entropy. labels (n,), mask (n,)."""
    nll = _nll(gcn_forward(params, feats, edge_index, cfg), labels)
    m = mask.to(torch.float32)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def graph_readout_loss(params, feats, edge_index, graph_ids, labels,
                       n_graphs: int, cfg: GCNConfig):
    """Batched small graphs: mean-pool per graph -> graph cross-entropy."""
    node_logits = gcn_forward(params, feats, edge_index, cfg)
    dev = node_logits.device
    ones = torch.ones(feats.shape[0], dtype=torch.float32, device=dev)
    cnt = torch.zeros(n_graphs, dtype=torch.float32, device=dev) \
        .index_add_(0, graph_ids, ones)
    pooled = torch.zeros((n_graphs, node_logits.shape[1]),
                         dtype=node_logits.dtype, device=dev) \
        .index_add(0, graph_ids, node_logits)
    pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
    return torch.mean(_nll(pooled, labels))

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

On DTensors (the dry-run's cells: node rows sharded over mesh dims ``S_n``,
edge columns over ``S_e``, both possibly empty) a propagation runs the
reference compile's lowering on each rank's local shards
(:class:`_ShardedGraph`, one per edge list), picking by the smaller of
``E`` and ``n`` as its HLO does (``minibatch_lg``'s 153,600 and 15,360
edges against 169,984 nodes; ``molecule``'s 16,384 edges against 3,840
nodes; ogbn-products on two pods with its nodes replicated):

* **edge plan** (``E < n``, nodes sharded): all-gather the edge list over
  ``S_e`` (``s32[E]`` twice); each rank gathers the messages ``h[src]`` of
  every edge from its own node rows, zeros elsewhere, and all-reduces the
  ``(E, d)`` rows over ``S_n``; it scales its own block of edges and the
  blocks are all-gathered over ``S_e``; the scatter-add is local, into
  the rank's own rows (the other edges into a spare row). The
  degrees come from the gathered edges. Backward: all-gather the
  aggregate's gradient over ``S_n``; the rest is local;
* **node plan** (otherwise): all-gather ``h`` over ``S_n``; the rank's own
  edges scatter their scaled messages into an ``(n, d)`` partial sum,
  all-reduced over ``S_e``; it keeps its own rows. Degrees are partial
  sums of the own edges, all-reduced over ``S_e``. Backward: the same two
  collectives on the gradient. Where ``data`` shards neither the rows nor
  the edges and shares a factor ``f`` with the rank's rows (Cora's 1,354
  rows a pod on two pods: ``f`` = 2), the reference's compile splits
  ``data`` into ``f`` x ``data / f`` (:func:`repro_torch.runtime.spmd.
  split_minor`): each rank takes its part of the rows; that part of every
  ``S_n`` block is all-gathered over ``S_n``; the ``(E_l, d)`` messages of
  the own edges, each from the part that holds its source, are
  all-reduced over the ``f`` ranks; the aggregate over ``S_e``.
  Backward: the aggregate's gradient all-gathered over ``S_n``, the
  parts' gradients reduce-scattered over it and all-gathered over the
  ``f`` ranks.

The graph readout's per-graph sums (:func:`_segment_sum`) add each rank's
own nodes into an ``(n_graphs, C)`` partial sum, all-reduced over the
nodes' mesh dims.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..runtime import spmd
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


def _propagator(h, edge_index):
    """``h -> Ã h`` for one edge list: the plain functions, or on a DTensor
    ``h`` the sharded lowering (module docstring)."""
    if spmd.is_dtensor(h):
        return _ShardedGraph(h, edge_index).propagate
    src, dst, coeff, self_c = _sym_coeffs(edge_index, h.shape[0])
    return lambda x: _propagate(x, src, dst, coeff, self_c)


def gcn_forward(params, feats, edge_index, cfg: GCNConfig):
    """feats (n, d_in), edge_index (2, e) int (padded rows = n). -> (n, C)."""
    h = feats.to(cfg.dtype)
    prop = _propagator(h, edge_index)
    for i, _ in enumerate(_dims(cfg)):
        h = _layer(params, i, prop(h), cfg)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def gcn_forward_layered(params, feats, edge_lists, cfg: GCNConfig):
    """Sampled-minibatch forward: layer ``i`` aggregates over ``edge_lists[i]``.

    ``edge_lists`` is outermost-hop-first (GraphSAGE block convention): the
    first GCN layer pulls hop-K features inward, the last one lands on the
    seed nodes. All node ids are subgraph-local; padded edges use ``n``.
    """
    h = feats.to(cfg.dtype)
    if len(edge_lists) != cfg.n_layers:
        raise ValueError(f"{len(edge_lists)} edge lists for "
                         f"{cfg.n_layers} layers")
    for i, edges in enumerate(edge_lists):
        h = _layer(params, i, _propagator(h, edges)(h), cfg)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def sampled_loss(params, feats, edge_lists, seed_labels, n_seeds: int,
                 cfg: GCNConfig):
    """Minibatch loss on the first ``n_seeds`` (seed) nodes of the subgraph."""
    logits = gcn_forward_layered(params, feats, edge_lists, cfg)
    if spmd.is_dtensor(logits):
        logits = _first_rows(logits, n_seeds)
    else:
        logits = logits[:n_seeds]
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
    if spmd.is_dtensor(node_logits):
        ones = torch.ones_like(node_logits[:, 0], dtype=torch.float32)
        cnt = _segment_sum(ones, graph_ids, n_graphs)
        pooled = _segment_sum(node_logits, graph_ids, n_graphs)
    else:
        dev = node_logits.device
        ones = torch.ones(feats.shape[0], dtype=torch.float32, device=dev)
        cnt = torch.zeros(n_graphs, dtype=torch.float32, device=dev) \
            .index_add_(0, graph_ids, ones)
        pooled = torch.zeros((n_graphs, node_logits.shape[1]),
                             dtype=node_logits.dtype, device=dev) \
            .index_add(0, graph_ids, node_logits)
    pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
    return torch.mean(_nll(pooled, labels))


# ------------------------------------------------------------ on DTensors
def _own(x, mesh, dims, n_rows: int):
    """The rank's block of ``n_rows`` rows of ``x`` over mesh ``dims``."""
    b = spmd.block_of(mesh, dims)
    return x[b * n_rows:(b + 1) * n_rows]


def _first_rows(x, n: int):
    """``x[:n]`` of DTensor rows, replicated: the rows gathered; the
    gradient goes back to the rows' own ranks as it is (no replicated
    product)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    out = _FirstRows.apply(x.to_local(), n, mesh,
                           spmd.shard_dims(x.placements, 0))
    return spmd.from_local(out, mesh, [Replicate()] * mesh.ndim)


class _FirstRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_l, n, mesh, dims):
        ctx.lo = spmd.block_of(mesh, dims) * x_l.shape[0]
        ctx.n_l = x_l.shape[0]
        return spmd.all_gather(x_l, mesh, dims, 0)[:n]

    @staticmethod
    def backward(ctx, g):
        own = g[ctx.lo:ctx.lo + ctx.n_l]
        return (torch.nn.functional.pad(own, (0, 0, 0, ctx.n_l
                                              - own.shape[0])),
                None, None, None)


class _ShardedGraph:
    """One edge list on DTensor node features: its plan, the edges each
    rank reads, the normalisation, and :meth:`propagate` (module
    docstring)."""

    def __init__(self, h, edge_index):
        from torch.distributed.tensor import Replicate

        mesh = self.mesh = h.device_mesh
        self.placements = h.placements
        if not spmd.is_dtensor(edge_index):
            edge_index = spmd.from_local(edge_index, mesh,
                                         [Replicate()] * mesh.ndim)
        n, e = h.shape[0], edge_index.shape[1]
        self.n = n
        self.s_n = spmd.shard_dims(h.placements, 0)
        self.s_e = spmd.shard_dims(edge_index.placements, 1)
        self.n_l = n // max(1, int(np.prod([mesh.size(d)
                                            for d in self.s_n])))
        self.edge_plan = bool(self.s_n) and e < n
        edges = edge_index.to_local()
        if self.edge_plan:
            edges = spmd.all_gather(edges, mesh, self.s_e, gather_dim=1)
        src, dst = edges[0].long(), edges[1].long()
        valid = (src < n) & (dst < n)
        self.src, self.dst = torch.where(valid, src, 0), torch.where(valid,
                                                                      dst, 0)
        deg = torch.zeros(n, dtype=torch.float32, device=src.device) \
            .index_add_(0, self.dst, valid.to(torch.float32))
        if not self.edge_plan:
            deg = spmd.all_reduce(deg, mesh, self.s_e)
        deg = deg + 1.0                                      # +1 self loop
        inv_sqrt = torch.rsqrt(deg)
        self.coeff = torch.where(valid, inv_sqrt[self.src]
                                 * inv_sqrt[self.dst], 0.0)
        self.self_c = 1.0 / _own(deg, mesh, self.s_n, self.n_l)
        self.part = None
        if not self.edge_plan and self.s_n and self.s_n == self.s_e:
            self._split_plan()
        if self.edge_plan:
            b = spmd.block_of(mesh, self.s_n)
            self.mask = (self.src // self.n_l) == b
            self.local = torch.where(self.mask, self.src - b * self.n_l, 0)
            self.dst_l = torch.where((self.dst // self.n_l) == b,
                                     self.dst - b * self.n_l, self.n_l)
            self.e_l = e // max(1, int(np.prod([mesh.size(d)
                                                for d in self.s_e])))

    def _split_plan(self):
        """The node plan on a mesh whose ``data`` dim shards neither the
        node rows nor the edges (``n / S_n`` not divisible by it): the
        rows' largest factor ``f`` in common with it splits ``data`` into
        ``f`` x ``data / f`` (a view of the mesh), the reference's sub-axis
        (module docstring)."""
        mesh = self.mesh
        names = list(mesh.mesh_dim_names)
        if "data" not in names:
            return
        d = names.index("data")
        f = math.gcd(self.n_l, mesh.size(d))
        if d in self.s_n or f == 1 or self.s_n != list(range(d)):
            return
        view, majd, _ = spmd.split_minor(mesh, list(range(d + 1)),
                                         mesh.size(d) // f)
        self.view, self.part = view, majd[-1]       # the f parts' mesh dim
        self.n_p = self.n_l // f
        p = spmd.block_of(view, [self.part])
        # the rank's part of its rows, and the edges whose source lies in
        # the same part of any block of S_n's rows
        self.rows = slice(p * self.n_p, (p + 1) * self.n_p)
        q, r = self.src // self.n_l, self.src % self.n_l
        self.mine = (r // self.n_p) == p
        self.idx = torch.where(self.mine, q * self.n_p + r % self.n_p, 0)

    def propagate(self, h):
        return spmd.from_local(_ShardedPropagate.apply(h.to_local(), self),
                               self.mesh, self.placements, h.shape)


class _ShardedPropagate(torch.autograd.Function):
    """``Ã h`` on the rank's node rows ``h_l`` (the graph's plan)."""

    @staticmethod
    def forward(ctx, h_l, graph):
        ctx.graph = graph
        mesh, n = graph.mesh, graph.n
        if graph.edge_plan:
            msg = torch.where(graph.mask[:, None], h_l[graph.local], 0)
            msg = spmd.all_reduce(msg, mesh, graph.s_n)
            own = (_own(msg, mesh, graph.s_e, graph.e_l)
                   * _own(graph.coeff, mesh, graph.s_e, graph.e_l)[:, None])
            # into the rank's own rows only, the other edges into a spare
            # row: the reference's partitioned scatter
            agg_l = torch.zeros((graph.n_l + 1, h_l.shape[1]),
                                dtype=h_l.dtype, device=h_l.device)
            agg_l.index_add_(0, graph.dst_l, spmd.all_gather(own, mesh,
                                                             graph.s_e))
            return agg_l[:graph.n_l] + h_l * graph.self_c[:, None]
        agg = torch.zeros((n, h_l.shape[1]), dtype=h_l.dtype,
                          device=h_l.device)
        if graph.part is not None:
            # the part's rows of every block of S_n; the own edges'
            # messages summed over the parts
            rows = spmd.all_gather(h_l[graph.rows], mesh, graph.s_n)
            msg = torch.where(graph.mine[:, None], rows[graph.idx], 0)
            msg = spmd.all_reduce(msg, graph.view, [graph.part])
            agg.index_add_(0, graph.dst, msg * graph.coeff[:, None])
        else:
            h_full = spmd.all_gather(h_l, mesh, graph.s_n)
            agg.index_add_(0, graph.dst,
                           h_full[graph.src] * graph.coeff[:, None])
        agg = spmd.all_reduce(agg, mesh, graph.s_e)
        return (_own(agg, mesh, graph.s_n, graph.n_l)
                + h_l * graph.self_c[:, None])

    @staticmethod
    def backward(ctx, g_l):
        graph = ctx.graph
        mesh, n = graph.mesh, graph.n
        g_full = spmd.all_gather(g_l, mesh, graph.s_n)
        contrib = g_full[graph.dst] * graph.coeff[:, None]   # per edge
        if graph.part is not None:
            d_rows = torch.zeros((n // graph.n_l * graph.n_p, g_l.shape[1]),
                                 dtype=g_l.dtype, device=g_l.device)
            d_rows.index_add_(0, graph.idx, torch.where(
                graph.mine[:, None], contrib, 0))
            d_h = spmd.all_gather(spmd.reduce_scatter(d_rows, mesh,
                                                      graph.s_n),
                                  graph.view, [graph.part])
        elif graph.edge_plan:
            d_h = torch.zeros_like(g_l).index_add_(
                0, graph.local, torch.where(graph.mask[:, None], contrib, 0))
        else:
            d_full = torch.zeros((n, g_l.shape[1]), dtype=g_l.dtype,
                                 device=g_l.device).index_add_(
                0, graph.src, contrib)
            d_full = spmd.all_reduce(d_full, mesh, graph.s_e)
            d_h = _own(d_full, mesh, graph.s_n, graph.n_l)
        return d_h + g_l * graph.self_c[:, None], None


def _segment_sum(x, ids, n_segments: int):
    """``zeros(n_segments, ...).index_add(0, ids, x)`` on DTensor rows:
    each rank adds its own rows, the partial sums are all-reduced over the
    rows' mesh dims (a replicated result)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    if spmd.is_dtensor(ids):
        if ids.placements != x.placements:
            ids = ids.redistribute(mesh, x.placements)
        ids = ids.to_local()
    out = _SegmentSum.apply(x.to_local(), ids, n_segments,
                            spmd.shard_dims(x.placements, 0), mesh)
    return spmd.from_local(out, mesh, [Replicate()] * mesh.ndim)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_l, ids_l, n_segments, dims, mesh):
        ctx.ids = ids_l.long()
        out = torch.zeros((n_segments, *x_l.shape[1:]), dtype=x_l.dtype,
                          device=x_l.device).index_add_(0, ctx.ids, x_l)
        return spmd.all_reduce(out, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.ids], None, None, None, None

"""Graph generators + a k-hop neighbor sampler, the GNN substrate (port
of :mod:`repro.data.graphs`; numpy, copied, so one seed gives the
reference's graphs bit for bit).

Three generators matched to the GCN shape cells:

* :func:`cora_like`: SBM citation graph with community-correlated features
  and labels (full-batch training);
* :func:`power_law_graph`: degree-heavy graph (the sampler has to survive
  10k-degree hubs; full-batch at ogbn-products' scale);
* :func:`molecule_batch`: many small graphs packed block-diagonally with a
  graph-id vector (batched small graphs).

:func:`sample_khop` is the neighbor sampler (GraphSAGE fanout sampling
over CSR), vectorised numpy: sampling is host-side data work and the
device step consumes its output.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "GraphData",
    "cora_like",
    "power_law_graph",
    "molecule_batch",
    "to_csr",
    "sample_khop",
]


@dataclasses.dataclass
class GraphData:
    features: np.ndarray      # (n, d) float32
    edge_index: np.ndarray    # (2, e) int32  (src, dst) — includes both directions
    labels: np.ndarray        # (n,) int32
    n_classes: int
    graph_ids: np.ndarray | None = None   # (n,) for batched small graphs

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_index.shape[1]


def _symmetrize(src, dst, n):
    e = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    # dedup + drop self loops (GCN adds its own)
    key = e[0].astype(np.int64) * n + e[1]
    _, keep = np.unique(key, return_index=True)
    e = e[:, keep]
    return e[:, e[0] != e[1]].astype(np.int32)


def cora_like(
    n_nodes: int = 2708,
    avg_degree: float = 4.0,
    d_feat: int = 1433,
    n_classes: int = 7,
    *,
    seed: int = 0,
    homophily: float = 0.8,
) -> GraphData:
    """SBM: intra-class edges with prob ``homophily``, features = class
    signature + sparse noise (binary bag-of-words-like, as Cora)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    m = int(n_nodes * avg_degree / 2)
    src = rng.integers(0, n_nodes, m * 2)
    intra = rng.random(m * 2) < homophily
    # intra-class partner: random node of the same class (via sorted buckets)
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(n_classes))
    ends = np.append(starts[1:], n_nodes)
    size = np.maximum(ends - starts, 1)
    rand_in_class = starts[labels[src]] + rng.integers(0, 1 << 30, m * 2) % size[labels[src]]
    dst_intra = order[rand_in_class]
    dst_rand = rng.integers(0, n_nodes, m * 2)
    dst = np.where(intra, dst_intra, dst_rand)
    edge_index = _symmetrize(src[:m], dst[:m], n_nodes)

    # Features: per-class salient words + noise, binarised.
    class_sig = rng.random((n_classes, d_feat)) < (30.0 / d_feat)
    noise = rng.random((n_nodes, d_feat)) < (10.0 / d_feat)
    feats = (class_sig[labels] | noise).astype(np.float32)
    return GraphData(feats, edge_index, labels, n_classes)


def power_law_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int = 100,
    n_classes: int = 47,
    *,
    seed: int = 0,
) -> GraphData:
    """Degree-heavy graph: endpoints drawn from a Zipf over nodes."""
    rng = np.random.default_rng(seed)
    m = n_edges // 2
    # Zipf-ranked endpoint sampling (approximates preferential attachment).
    u = rng.random((2, m))
    ends = (n_nodes * u ** 2.5).astype(np.int64)     # heavy head
    src, dst = np.clip(ends, 0, n_nodes - 1)
    perm = rng.permutation(n_nodes)                   # decorrelate id order
    edge_index = _symmetrize(perm[src], perm[dst], n_nodes)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    feats += np.eye(n_classes, d_feat, dtype=np.float32)[labels] * 2.0
    return GraphData(feats, edge_index, labels, n_classes)


def molecule_batch(
    batch: int = 128,
    nodes_per_graph: int = 30,
    edges_per_graph: int = 64,
    d_feat: int = 16,
    n_classes: int = 2,
    *,
    seed: int = 0,
) -> GraphData:
    """``batch`` random small graphs, block-diagonal edge list + graph ids."""
    rng = np.random.default_rng(seed)
    n = batch * nodes_per_graph
    srcs, dsts = [], []
    for g in range(batch):
        base = g * nodes_per_graph
        # ring (molecule backbone) + random chords
        ring = np.arange(nodes_per_graph)
        srcs.append(base + ring)
        dsts.append(base + (ring + 1) % nodes_per_graph)
        extra = edges_per_graph // 2 - nodes_per_graph
        if extra > 0:
            srcs.append(base + rng.integers(0, nodes_per_graph, extra))
            dsts.append(base + rng.integers(0, nodes_per_graph, extra))
    edge_index = _symmetrize(np.concatenate(srcs), np.concatenate(dsts), n)
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    graph_ids = np.repeat(np.arange(batch, dtype=np.int32), nodes_per_graph)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)  # per-graph
    return GraphData(feats, edge_index, labels, n_classes, graph_ids=graph_ids)


def to_csr(edge_index: np.ndarray, n_nodes: int):
    """(2, e) COO -> (indptr (n+1,), indices (e,)) CSR over dst->src.

    ``indices[indptr[v]:indptr[v+1]]`` are the in-neighbors of ``v`` —
    the set a sampled-training step aggregates from.
    """
    src, dst = edge_index
    order = np.argsort(dst, kind="stable")
    indices = src[order].astype(np.int32)
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def sample_khop(
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    *,
    rng: np.random.Generator | None = None,
):
    """GraphSAGE-style layered uniform neighbor sampling (with replacement).

    Returns ``layers``: list (len(fanouts)) of ``(src (m_i,), dst (m_i,))``
    *edge arrays in global node ids*, hop ``i`` connecting hop-i sampled
    sources into the hop-(i-1) frontier, plus the full unique ``node_set``.
    Isolated nodes self-loop (standard practice) so shapes stay static:
    ``m_i = len(frontier_i) * fanout_i`` exactly.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    frontier = np.asarray(seeds, np.int32)
    layers = []
    all_nodes = [frontier]
    for fanout in fanouts:
        deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        # uniform with replacement; degree-0 nodes self-loop
        r = rng.integers(0, 1 << 62, size=(len(frontier), fanout))
        offs = np.where(deg[:, None] > 0, r % np.maximum(deg, 1)[:, None], 0)
        base = indptr[frontier][:, None]
        src = indices[(base + offs).astype(np.int64)]
        src = np.where(deg[:, None] > 0, src, frontier[:, None]).astype(np.int32)
        dst = np.repeat(frontier, fanout).astype(np.int32)
        layers.append((src.reshape(-1), dst))
        frontier = np.unique(src)
        all_nodes.append(frontier)
    node_set = np.unique(np.concatenate(all_nodes))
    return layers, node_set

"""CellDec — the weight-region baseline of [Singitham et al., VLDB'04]
(port of :mod:`repro.core.celldec`).

The weight simplex is split into regions: corner region ``i`` where
``w_i >= 1/2`` and the central region ``s`` otherwise (the paper's regular
4-split at ``s = 3``). Each region gets its own cluster-prune index over a
composite corpus (k-means in [18], one clustering); a query is routed to
its weight's region, navigates and scores in that region's composite space
through ``index.search`` on the ``reference`` backend, and the returned ids
are rescored exactly against the un-squeezed corpus.

The composite is built as the reference builds it: the fields are
squeezed by ``theta``, then each field and the whole row are normalised
again.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from ..kernels.common import resolve_device
from .fields import FieldSpec, normalize_fields
from .index import ClusterPruneIndex
from .weights import expand_weights, weighted_query

__all__ = ["CellDecIndex", "region_of", "region_weights"]


def region_weights(spec: FieldSpec, theta: float = 0.5) -> np.ndarray:
    """Per-region squeeze vectors ``(s + 1, s)``: row ``r < s`` squeezes
    every field but ``r`` by ``theta``; row ``s`` (central) is all ones."""
    s = spec.s
    sq = np.full((s + 1, s), theta, dtype=np.float32)
    sq[np.arange(s), np.arange(s)] = 1.0
    sq[s, :] = 1.0
    return sq


def region_of(w, s: int) -> torch.Tensor:
    """Region id of weight vectors ``w (..., s)``: corner ``i`` where
    ``w_i >= 1/2`` (the first largest such weight on ties), else the
    central region ``s``."""
    w = torch.as_tensor(w)
    big = w >= 0.5
    corner = torch.argmax(torch.where(big, w, float("-inf")), dim=-1)
    return torch.where(big.any(dim=-1), corner,
                       torch.full_like(corner, s)).to(torch.int32)


@dataclasses.dataclass
class CellDecIndex:
    """One cluster-prune index per weight region over composite corpora."""

    spec: FieldSpec
    theta: float
    indexes: list[ClusterPruneIndex]   # s + 1 region indexes
    docs: torch.Tensor                 # (n, D) un-squeezed corpus (rescore)

    @classmethod
    def build(cls, docs, spec: FieldSpec, k_clusters: int, *,
              theta: float = 0.5, method: str = "kmeans",
              n_clusterings: int = 1,
              generator: torch.Generator | None = None, device=None,
              draws: Sequence[Sequence] | None = None,
              **clusterer_kwargs) -> "CellDecIndex":
        """One index per region, ``n_clusterings`` (1, as [18]) clusterings
        each, on ``device`` (the card unless ``"cpu"``), with
        ``pack_major=False``: region indexes are searched on the
        ``reference`` backend only. ``generator`` (seed 0 when None) draws
        every region's clusterings in turn; ``draws[r]`` gives region
        ``r``'s draws instead (see :meth:`ClusterPruneIndex.build`)."""
        dev = resolve_device(device)
        docs = torch.as_tensor(np.asarray(docs) if not isinstance(
            docs, torch.Tensor) else docs).to(dev, torch.float32).contiguous()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sq = region_weights(spec, theta)
        indexes = []
        for r in range(sq.shape[0]):
            squeeze = expand_weights(torch.as_tensor(sq[r], device=dev), spec)
            comp = normalize_fields(docs * squeeze[None, :], spec)
            comp = comp / torch.clamp(
                torch.linalg.vector_norm(comp, dim=-1, keepdim=True),
                min=1e-12)
            indexes.append(ClusterPruneIndex.build(
                comp, spec, k_clusters, n_clusterings=n_clusterings,
                method=method, generator=generator, pack_major=False,
                device=dev, draws=None if draws is None else draws[r],
                **clusterer_kwargs,
            ))
        return cls(spec=spec, theta=theta, indexes=indexes, docs=docs)

    def search_weighted(self, q, w, *, probes: int, k: int, exclude=None):
        """Route each query to its weight region's index; rescore exactly.

        Queries are grouped by region on the host. Navigation and bucket
        scoring run in the region's composite space; the returned ``k`` ids
        are rescored against the un-squeezed corpus with the true weights
        and sorted by a stable descending sort (equal scores keep the
        index's order). Returns ``(scores (nq, k), ids (nq, k),
        n_scored (nq,))`` on the index's device."""
        dev = self.docs.device
        q = torch.atleast_2d(torch.as_tensor(q, device=dev))
        w = torch.atleast_2d(torch.as_tensor(w, dtype=torch.float32,
                                             device=dev))
        nq = q.shape[0]
        if exclude is None:
            exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
        exclude = torch.as_tensor(exclude, device=dev).to(torch.int32)
        regions = region_of(w.cpu(), self.spec.s).numpy()
        sq = region_weights(self.spec, self.theta)

        scores = torch.zeros((nq, k), dtype=torch.float32, device=dev)
        ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
        scored = torch.zeros((nq,), dtype=torch.int64, device=dev)
        for r in range(self.spec.s + 1):
            sel_np = np.nonzero(regions == r)[0]
            if sel_np.size == 0:
                continue
            sel = torch.as_tensor(sel_np, device=dev)
            comp_q = weighted_query(
                q[sel],
                torch.as_tensor(sq[r], device=dev).expand(sel.numel(), -1),
                self.spec)
            _, i_r, n_r = self.indexes[r].search(
                comp_q, probes=probes, k=k, exclude=exclude[sel])
            qw = weighted_query(q[sel], w[sel], self.spec)
            safe = torch.where(i_r >= 0, i_r, 0).long()
            exact = torch.einsum("qkd,qd->qk", self.docs[safe], qw)
            exact = torch.where(i_r >= 0, exact,
                                torch.tensor(float("-inf"), device=dev))
            order = torch.sort(-exact, dim=-1, stable=True).indices
            scores[sel] = torch.gather(exact, -1, order)
            ids[sel] = torch.gather(i_r, -1, order).to(torch.int32)
            scored[sel] = n_r.to(torch.int64)
        return scores, ids, scored

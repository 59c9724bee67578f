"""Pluggable search-engine layer (port of :mod:`repro.core.engine`).

``reference``
    Plain PyTorch doc-major gather (:func:`_search_block`) — the portable
    path and the semantics oracle.
``fused``
    Navigation, the on-device probe-dedup schedule, then the query-tiled
    ``bucket_score_tiled`` kernel over the bucket-major pack (the CUDA
    kernel on the card; its plain version on the CPU).

Both share probe splitting, the ``T·K`` clamp, duplicate suppression across
clusterings, ``exclude`` masking, the Fig-1 ``n_scored`` accounting, the
exact-rescore tail, the exact tier and the escalation driver. Every top-k
here breaks ties toward the lower index (a stable descending sort), as
``lax.top_k`` does. The ``sharded`` backend is not ported yet.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch
import torch.nn.functional as F

__all__ = [
    "SearchEngine",
    "BACKENDS",
    "register_backend",
    "available_backends",
    "pick_backend",
    "get_engine",
    "split_probes",
    "sweep_probes",
    "stable_topk",
]


def split_probes(probes: int, t: int) -> tuple[int, ...]:
    """Distribute a total probe budget over T clusterings (evenly)."""
    base, rem = divmod(probes, t)
    return tuple(base + (1 if i < rem else 0) for i in range(t))


def stable_topk(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, ties
    to the lower index — ``lax.top_k``'s rule, which ``torch.topk`` does not
    promise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@runtime_checkable
class SearchEngine(Protocol):
    """What every backend provides: batched pruned top-k over one index."""

    name: str

    def search(self, qw, *, probes, k, exclude=None, nav_query=None,
               rescore=None):
        """-> (scores (nq, k), ids (nq, k), n_scored (nq,))."""
        ...

    def search_weighted(self, q, w, *, probes, k, exclude=None):
        ...


BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    """Class decorator: register a :class:`SearchEngine` implementation."""

    def deco(cls):
        cls.name = name
        BACKENDS[name] = cls
        return cls

    return deco


def available_backends() -> tuple[str, ...]:
    return tuple(BACKENDS)


def pick_backend(index=None) -> str:
    """``fused`` for an index on a CUDA device, ``reference`` otherwise."""
    if index is not None and index.docs.device.type == "cuda":
        return "fused"
    return "reference"


def get_engine(index, backend: str = "auto", **opts) -> SearchEngine:
    """Engine for ``index``, cached on the index keyed by ``(name, opts)``
    (unhashable opts construct uncached). The first use of a key builds
    its engine once, under the index's ``build_lock`` (serving replicas
    ask from several threads)."""
    name = pick_backend(index) if backend in (None, "auto") else backend
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(BACKENDS)}"
        )
    cls = BACKENDS[name]
    try:
        key = (name, tuple(sorted(opts.items())))
        hash(key)
    except TypeError:
        return cls(index, **opts)
    engine = index.__dict__.get("_engines", {}).get(key)
    if engine is not None:
        return engine
    with index.build_lock():
        cache = index.__dict__.setdefault("_engines", {})
        if key not in cache:
            cache[key] = cls(index, **opts)
        return cache[key]


# Memory cap for the reference backend's (qchunk, m, D) candidate gather
# during a sweep.
_SWEEP_GATHER_BYTES = 512 * 2**20


def sweep_probes(index, qw, *, probe_grid, k, exclude=None, nav_query=None,
                 backend=None, engine_opts=None, rescore=None):
    """Run ONE engine over a probe grid; for ``reference`` the query chunk
    shrinks per level to keep the candidate gather within a fixed budget.
    Returns one ``(scores, ids, n_scored)`` per grid entry."""
    name = pick_backend(index) if backend in (None, "auto") else backend
    grid = [int(p) for p in probe_grid]
    opts = dict(engine_opts or {})
    b = int(index.buckets.shape[-1])
    d = int(index.docs.shape[-1])
    out = []
    for probes in grid:
        level_opts = opts
        if name == "reference" and "qchunk" not in opts:
            qchunk = max(
                1, min(8, _SWEEP_GATHER_BYTES // max(1, probes * b * d * 4))
            )
            level_opts = {**opts, "qchunk": int(qchunk)}
        eng = get_engine(index, name, **level_opts)
        out.append(eng.search(qw, probes=probes, k=k, exclude=exclude,
                              nav_query=nav_query, rescore=rescore))
    return out


# Exact tier on a quantised pack: the pack proposes candidates, the fp32
# rescore tail ranks them.
_EXACT_RESCORE_FACTOR = 4


class _EngineBase:
    """Shared canonicalisation, probe selection and cost accounting."""

    uses_packed_storage = False

    def __init__(self, index):
        self.index = index

    def search_weighted(self, q, w, *, probes, k, exclude=None):
        """Per-field query ``q`` and weights ``w`` through the paper's §4
        reduction; a 1-D query keeps the squeezed ``(k,)`` result shape."""
        from .weights import weighted_query

        dev = self.index.docs.device
        qw = weighted_query(torch.as_tensor(q, device=dev),
                            torch.as_tensor(w, device=dev), self.index.spec)
        return self.search(qw, probes=probes, k=k, exclude=exclude)

    def _canonical(self, qw, nav_query, exclude):
        dev = self.index.docs.device
        qw = torch.as_tensor(qw, device=dev)
        single = qw.dim() == 1
        qw = torch.atleast_2d(qw)
        nav = qw if nav_query is None else torch.atleast_2d(
            torch.as_tensor(nav_query, device=dev))
        nq = qw.shape[0]
        if exclude is None:
            exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
        exclude = torch.atleast_1d(torch.as_tensor(exclude, device=dev))
        exclude = exclude.to(torch.int32).expand(nq).contiguous()
        return qw, nav, exclude, single

    @staticmethod
    def _finish(single, scores, ids, n_scored):
        if single:
            return scores[0], ids[0], n_scored[0]
        return scores, ids, n_scored

    def _total_probes(self) -> int:
        """T·K — the budget at which pruned search is exact search."""
        t, k_clusters = (int(x) for x in self.index.counts.shape)
        return t * k_clusters

    def _probes_t(self, probes: int) -> tuple[int, ...]:
        t = self.index.leaders.shape[0]
        return split_probes(min(int(probes), self._total_probes()), t)

    def _flat_probes(self, nav, probes_t):
        """Navigate: ``(nq, P)`` flattened ``t·K + cluster`` probe list."""
        leaders = self.index.leaders
        k_clusters = leaders.shape[1]
        lsims = torch.einsum("tkd,qd->qtk", leaders, nav)
        parts = []
        for t, p in enumerate(probes_t):
            if p == 0:
                continue
            _, top_c = stable_topk(lsims[:, t, :], p)
            parts.append(top_c + t * k_clusters)
        return torch.cat(parts, dim=-1).to(torch.int32)

    def _n_scored(self, flat_probes):
        """Fig-1 accounting: every member of a probed bucket (dups across
        clusterings included) plus the T·K leader comparisons."""
        t, k_clusters = self.index.counts.shape
        counts = self.index.counts.reshape(-1)
        return (counts[flat_probes.long()].sum(dim=-1).to(torch.int32)
                + t * k_clusters)

    def search_exact(self, qw, *, k, exclude=None, nav_query=None,
                     rescore=None):
        """Clustered exact top-k: sweep all T·K buckets. A backend scoring
        from a bf16/int8 pack goes through the fp32 rescore tail at depth
        ``max(rescore, 4k)``; ids and scores then equal brute force exactly
        when every true neighbour is among the pack's ``4k`` best scores,
        which quantisation noise does not guarantee."""
        quantised = self.uses_packed_storage and (
            self.index.pack_dtype not in (None, "float32")
        )
        if quantised:
            depth = max(int(rescore or 0), _EXACT_RESCORE_FACTOR * k)
            rescore = max(k, min(depth, int(self.index.n_docs)))
        return self.search(qw, probes=self._total_probes(), k=k,
                           exclude=exclude, nav_query=nav_query,
                           rescore=rescore)

    def search_escalating(self, qw, *, probes, k, min_recall, exclude=None,
                          nav_query=None, rescore=None):
        """Recall-floor escalation: run the planned budget; while the
        index's calibrated ladder predicts recall below ``min_recall``,
        re-run at the next rung above — bumped to the rung the fit says
        meets the floor (``ladder.plan``) — and at the exact tier once the
        rungs run out (at once, when no ladder exists to predict with).
        Every tier's candidates are charged to ``n_scored``. Returns
        ``(scores, ids, n_scored, info)``, ``info`` carrying ``tier``
        ("approx" | "escalated" | "exact"), ``escalations``, the final
        ``probes`` and its ``predicted_recall``."""
        if not 0.0 < float(min_recall) <= 1.0:
            raise ValueError(f"min_recall must be in (0, 1], got {min_recall}")
        ladder = self.index.ladder
        total = self._total_probes()
        qw2, nav, excl, single = self._canonical(qw, nav_query, exclude)
        p = min(int(probes), total)
        escalations = 0
        n_total = None
        while True:
            if p >= total:
                s, i, ns = self.search_exact(qw2, k=k, exclude=excl,
                                             nav_query=nav, rescore=rescore)
                predicted = 1.0
            else:
                s, i, ns = self.search(qw2, probes=p, k=k, exclude=excl,
                                       nav_query=nav, rescore=rescore)
                predicted = (None if ladder is None
                             else float(ladder.predicted_recall(p)))
            n_total = ns if n_total is None else n_total + ns
            if p >= total or (predicted is not None
                              and predicted >= float(min_recall)):
                break
            nxt = total
            if ladder is not None:
                above = next((int(r) for r in ladder.probes if int(r) > p),
                             total)
                nxt = min(max(above, int(ladder.plan(float(min_recall)))),
                          total)
            p = nxt if nxt > p else total
            escalations += 1
        tier = ("exact" if p >= total
                else ("escalated" if escalations else "approx"))
        info = {"tier": tier, "escalations": escalations, "probes": int(p),
                "predicted_recall": float(predicted)}
        s, i, n_total = self._finish(single, s, i, n_total)
        return s, i, n_total, info

    def _search_rescored(self, qw, *, probes, k, rescore, exclude=None,
                         nav_query=None):
        """Exact-rescore tail: pruned search at depth ``rescore`` (>= k),
        fp32 re-score of the candidates, exact top-k cut; the re-scored
        candidates are charged to ``n_scored``."""
        rescore = int(rescore)
        if rescore < k:
            raise ValueError(f"rescore depth {rescore} must be >= k ({k})")
        qw2, nav, exclude, single = self._canonical(qw, nav_query, exclude)
        s, ids, n_scored = self.search(qw2, probes=probes, k=rescore,
                                       exclude=exclude, nav_query=nav)
        rs, ri, extra = _exact_rescore(self.index.docs, qw2, ids, k)
        return self._finish(single, rs, ri, n_scored + extra)


def _exact_rescore(docs, qw, ids, k):
    """Re-score candidate ids against the fp32 corpus; exact top-k cut.
    ``-1`` fillers score ``-inf`` and return as ``-1``; also returns the
    per-query count of candidates re-scored."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    cvecs = docs[safe]                                   # (nq, R, D)
    s = torch.einsum("qrd,qd->qr", cvecs, qw)
    s = torch.where(valid, s, torch.tensor(float("-inf"), device=s.device))
    top_s, pos = stable_topk(s, k)
    top_i = torch.gather(ids, -1, pos)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return top_s, top_i, valid.sum(dim=-1).to(torch.int32)


@register_backend("reference")
class ReferenceEngine(_EngineBase):
    """Plain PyTorch doc-major gather path — the portable oracle."""

    def __init__(self, index, *, qchunk: int = 8):
        super().__init__(index)
        self.qchunk = qchunk

    def search(self, qw, *, probes, k, exclude=None, nav_query=None,
               rescore=None):
        if rescore is not None:
            return self._search_rescored(qw, probes=probes, k=k,
                                         rescore=rescore, exclude=exclude,
                                         nav_query=nav_query)
        index = self.index
        qw, nav, exclude, single = self._canonical(qw, nav_query, exclude)
        probes_t = self._probes_t(probes)
        parts = [
            _search_block(index.docs, index.leaders, index.buckets,
                          qw[i:i + self.qchunk], nav[i:i + self.qchunk],
                          exclude[i:i + self.qchunk], probes_t=probes_t, k=k)
            for i in range(0, qw.shape[0], self.qchunk)
        ]
        scores, ids, scored = (torch.cat(x) for x in zip(*parts))
        return self._finish(single, scores, ids, scored)


def _search_block(docs, leaders, buckets, qw, nav, exclude, *, probes_t, k):
    """One query block: probe -> gather buckets -> score the union ->
    dedup -> top-k."""
    n = docs.shape[0]
    lsims = torch.einsum("tkd,qd->qtk", leaders, nav)
    cand_parts = []
    for t, p in enumerate(probes_t):
        if p == 0:
            continue
        _, top_clusters = stable_topk(lsims[:, t, :], p)
        cand_parts.append(buckets[t][top_clusters].reshape(qw.shape[0], -1))
    cand = torch.cat(cand_parts, dim=-1)                    # (bq, m)
    neg = torch.tensor(float("-inf"), device=docs.device)
    valid = cand < n
    safe = torch.where(valid, cand, 0).long()
    scores = torch.einsum("qmd,qd->qm", docs[safe], qw)
    scores = torch.where(valid, scores, neg)
    scores = torch.where(cand == exclude[:, None], neg, scores)
    # identical doc => identical score: sort by id, keep one copy
    c_sorted, order = torch.sort(cand, dim=-1, stable=True)
    s_sorted = torch.gather(scores, -1, order)
    dup = c_sorted == F.pad(c_sorted[:, :-1], (1, 0), value=-1)
    s_sorted = torch.where(dup, neg, s_sorted)
    top_s, pos = stable_topk(s_sorted, k)
    top_ids = torch.gather(c_sorted, -1, pos)
    top_ids = torch.where(torch.isfinite(top_s), top_ids, -1).to(torch.int32)
    n_scored = (valid.sum(dim=-1) + leaders.shape[0] * leaders.shape[1]
                ).to(torch.int32)
    return top_s, top_ids, n_scored


@register_backend("fused")
class FusedEngine(_EngineBase):
    """Query-tiled scoring over the bucket-major pack.

    Per batch: navigate once, build the probe-dedup schedule on the device
    (a static power-of-two ``S``, no host round trip), then one
    ``bucket_score_tiled`` call scores each scheduled bucket against the
    whole query tile with a fused running top-k. The pack may be fp32,
    bf16 or int8 (``ClusterPruneIndex.pack_dtype``), accumulated in fp32.
    ``query_tile`` defaults to the CUDA kernel's tile
    (:func:`~repro_torch.kernels.bucket_score.ops.pick_query_tile`, 16),
    floored by the batch.
    """

    uses_packed_storage = True

    def __init__(self, index, *, query_tile: int | None = None):
        super().__init__(index)
        self.query_tile = query_tile

    def kernel_inputs(self, qw, *, probes, k, exclude=None, nav_query=None):
        """Navigate and schedule one batch: ``(flat_probes, args, kwargs)``
        with ``bucket_score_tiled(*args, **kwargs)`` the batch's scoring
        call (the tools that hold the kernel against its plain version on
        the main path's own inputs use this too)."""
        from ..kernels.bucket_score import (
            build_probe_schedule_device, pick_query_tile, schedule_length,
        )
        from ..kernels.common import pad_to

        qw, nav, exclude, _ = self._canonical(qw, nav_query, exclude)
        data, ids, scales = self.index.ensure_bucket_major()
        flat = self._flat_probes(nav, self._probes_t(probes))
        n_buckets, b, d = (int(x) for x in data.shape)
        qt = self.query_tile
        if qt is None:
            qt = min(
                pick_query_tile(d, b, k_pad=pad_to(k, 8),
                                pack_itemsize=data.element_size()),
                pad_to(qw.shape[0], 8),
            )
        s_len = schedule_length(qt, int(flat.shape[1]), n_buckets)
        sched, member = build_probe_schedule_device(flat, query_tile=qt,
                                                    s_len=s_len)
        return flat, (qw.contiguous(), data, ids, sched, member), dict(
            k=k, exclude=exclude, scales=scales)

    def search(self, qw, *, probes, k, exclude=None, nav_query=None,
               rescore=None):
        if rescore is not None:
            return self._search_rescored(qw, probes=probes, k=k,
                                         rescore=rescore, exclude=exclude,
                                         nav_query=nav_query)
        from ..kernels.bucket_score import bucket_score_tiled

        single = torch.as_tensor(qw).dim() == 1
        flat, args, kwargs = self.kernel_inputs(
            qw, probes=probes, k=k, exclude=exclude, nav_query=nav_query)
        s, i = bucket_score_tiled(*args, **kwargs)
        i = torch.where(torch.isfinite(s), i, -1)
        return self._finish(single, s, i, self._n_scored(flat))

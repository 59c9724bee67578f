"""Typed retrieval API — the user-facing contract (port of
:mod:`repro.core.api`).

:class:`SearchRequest`
    One query: a ``query`` vector (concatenated or per-field blocks) or
    ``like=doc_id`` (more-like-this, self-excluding), weights by field name,
    ``k``, a ``probes`` budget or a ``recall_target``, ``exclude``,
    ``backend``, the ``rescore`` tail, and the tiers ``exact=`` /
    ``min_recall=``.
:class:`SearchResponse` / :class:`Hit`
    Ranked hits with the exact per-field score decomposition, plus
    ``n_scored``, latency, backend, probes and tier.
:class:`Retriever`
    Owns the index and its engines; groups a heterogeneous batch by
    :class:`ExecShape` into one engine call per shape; memoises
    ``(like, weights) -> qw`` and whole more-like-this responses, both keyed
    by ``index.version``.

Planning follows the reference: a ``recall_target=`` plans from the
index's calibrated :class:`~repro_torch.core.calibrate.ProbeLadder` (fitted
lazily on the first such request with ``calibrate=True``, refitted when
stale) and a ``min_recall=`` floor escalates up its rungs; without a ladder
a target plans from the static ladder (with a warning) and a floor is
answered by the exact tier.

``Retriever.add`` / ``remove`` mutate the served index and flush every
request cache; a mutation applied to the index directly is caught by the
``version`` check at the start of each batch.

While a profiler is open (``repro_torch.runtime.trace``) a batch records
the spans ``api.resolve`` (cache lookups, queries and weights),
``api.plan`` (planning and grouping) and ``api.respond`` (the per-field
decomposition, the copies to the host, the hits) and the counters
``api.scored`` (the responses' ``n_scored``), ``api.candidates``
(requests times live rows), ``api.raw_queries`` (raw query vectors
resolved) and ``api.resolve_syncs`` (the batch validity checks made for
them: one for each resolution that has raw vectors; it counts the checks,
not syncs measured on the device).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import OrderedDict
from typing import Callable, Iterable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..runtime.trace import count, profiling, span
from .fields import FieldSpec, normalize_fields
from .index import ClusterPruneIndex
from .weights import validate_weights, weighted_query

__all__ = [
    "SearchRequest",
    "Hit",
    "SearchResponse",
    "Retriever",
    "ExecShape",
    "exec_shape",
    "plan_probes",
    "decompose_scores",
]


# STATIC FALLBACK ladder (the reference's): recall_target -> fraction of
# the T·K clusters to probe.
_RECALL_LADDER: tuple[tuple[float, float], ...] = (
    (0.50, 0.04),
    (0.80, 0.10),
    (0.90, 0.20),
    (0.95, 0.35),
    (0.99, 0.60),
)


def plan_probes(recall_target: float, n_clusterings: int,
                k_clusters: int) -> int:
    """Map a recall target in (0, 1] to a total probe budget from the
    static ladder, clamped to ``[T, T·K]``."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(
            f"recall_target must be in (0, 1], got {recall_target}"
        )
    total = n_clusterings * k_clusters
    frac = 1.0
    for target, f in _RECALL_LADDER:
        if recall_target <= target:
            frac = f
            break
    probes = math.ceil(frac * total)
    return max(n_clusterings, min(total, probes))


class ExecShape(NamedTuple):
    """The grouping key for batchable requests — one engine call per shape:
    backend, realised probe budget, ``k``, rescore depth, tier and (for the
    escalate tier) the recall floor."""

    backend: str
    probes: int
    k: int
    rescore: int | None
    tier: str = "approx"
    min_recall: float | None = None


def exec_shape(
    req: "SearchRequest",
    *,
    default_backend: str,
    default_probes: int,
    plan_target: Callable[[float], int] | None = None,
    total_probes: int | None = None,
    predict_recall: Callable[[int], float | None] | None = None,
) -> ExecShape:
    """Resolve one request to its :class:`ExecShape` (the reference's
    contract: ``"auto"`` resolves here, explicit budgets clamp to ``T·K``,
    ``exact=True`` pins ``T·K``, a ``min_recall=`` floor with no predictor
    goes to the exact tier)."""
    backend = req.backend or default_backend
    if backend == "auto":
        backend = default_backend
    if backend in (None, "auto"):
        from .engine import pick_backend

        backend = pick_backend()
    if req.exact:
        if total_probes is None:
            raise ValueError(
                "request carries exact=True but total_probes= (T*K) was not "
                "given; resolve shapes through Retriever.exec_shape"
            )
        return ExecShape(backend, int(total_probes), req.k, req.rescore,
                         "exact", None)
    if req.probes is not None:
        probes = int(req.probes)
    elif req.recall_target is not None:
        if plan_target is None:
            raise ValueError(
                "request carries recall_target= but no plan_target planner "
                "was given; resolve shapes through Retriever.exec_shape"
            )
        probes = int(plan_target(req.recall_target))
    else:
        probes = int(default_probes)
    if total_probes is not None:
        probes = min(probes, int(total_probes))
    if req.min_recall is not None:
        predicted = (
            predict_recall(probes) if predict_recall is not None else None
        )
        if predicted is None:
            if total_probes is None:
                raise ValueError(
                    "request carries min_recall= but no predict_recall "
                    "predictor or total_probes= fallback was given"
                )
            return ExecShape(backend, int(total_probes), req.k, req.rescore,
                             "exact", None)
        if float(predicted) < float(req.min_recall):
            return ExecShape(backend, probes, req.k, req.rescore, "escalate",
                             float(req.min_recall))
    return ExecShape(backend, probes, req.k, req.rescore)


@dataclasses.dataclass(frozen=True, eq=False)
class SearchRequest:
    """One dynamically-weighted similarity query (see the reference's
    :class:`repro.core.api.SearchRequest` for the full contract)."""

    query: torch.Tensor | np.ndarray | Sequence | None = None
    like: int | None = None
    weights: Mapping[str, float] | Sequence[float] | None = None
    k: int = 10
    probes: int | None = None
    recall_target: float | None = None
    exclude: int | None = None
    backend: str | None = None
    rescore: int | None = None
    exact: bool = False
    min_recall: float | None = None

    def __post_init__(self):
        if (self.query is None) == (self.like is None):
            raise ValueError(
                "exactly one of query= (keyword embedding) or like= (doc id) "
                "must be given"
            )
        if self.like is not None and int(self.like) < 0:
            raise ValueError(f"like= must be a doc id >= 0, got {self.like}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.probes is not None and self.recall_target is not None:
            raise ValueError("give either probes= or recall_target=, not both")
        if self.probes is not None and self.probes < 1:
            raise ValueError(f"probes must be >= 1, got {self.probes}")
        if self.recall_target is not None and not (
            0.0 < self.recall_target <= 1.0
        ):
            raise ValueError(
                f"recall_target must be in (0, 1], got {self.recall_target}"
            )
        if self.rescore is not None and self.rescore < self.k:
            raise ValueError(
                f"rescore depth must be >= k ({self.k}), got {self.rescore}"
            )
        if self.exact:
            if self.probes is not None or self.recall_target is not None:
                raise ValueError(
                    "exact=True sweeps every cluster; a probes=/"
                    "recall_target= budget alongside it is contradictory"
                )
            if self.min_recall is not None:
                raise ValueError(
                    "exact=True already guarantees recall 1.0; give either "
                    "exact=True or min_recall=, not both"
                )
        if self.min_recall is not None and not (
            0.0 < self.min_recall <= 1.0
        ):
            raise ValueError(
                f"min_recall must be in (0, 1], got {self.min_recall}"
            )

    def resolve_weights(self, spec: FieldSpec) -> np.ndarray:
        """Per-field weight vector ``(s,)`` in spec order, validated."""
        return validate_weights(_weight_rows(spec, [self])[0], spec)

    def resolve_query(self, index: ClusterPruneIndex) -> torch.Tensor:
        """The unweighted ``(D,)`` query (per-field unit-normalised)."""
        return _resolve_queries(index, [self])[0]

    def resolve_exclude(self) -> int:
        """Doc id to mask (-1 = none). MLT requests self-exclude by default."""
        if self.exclude is not None:
            return int(self.exclude)
        return int(self.like) if self.like is not None else -1


def _weight_rows(spec: FieldSpec, reqs: Sequence[SearchRequest]
                 ) -> np.ndarray:
    """``(n, s)`` float32 weights of the requests in spec order, not yet
    validated (no weights: every field alike)."""
    w = np.empty((len(reqs), spec.s), np.float32)
    names = set(spec.names)
    for i, r in enumerate(reqs):
        if r.weights is None:
            w[i] = 1.0 / spec.s
        elif isinstance(r.weights, Mapping):
            unknown = set(r.weights) - names
            if unknown:
                raise ValueError(
                    f"unknown field name(s) {sorted(unknown)}; "
                    f"corpus fields are {list(spec.names)}"
                )
            w[i] = [float(r.weights.get(n, 0.0)) for n in spec.names]
        else:
            row = np.asarray(r.weights, np.float32)
            if row.shape != (spec.s,):
                raise ValueError(
                    f"weights must have one entry per field "
                    f"({spec.s}: {list(spec.names)}), got shape {row.shape}"
                )
            w[i] = row
    return w


def _query_blocks(req: SearchRequest) -> list[torch.Tensor]:
    """A raw query as flat tensors where the caller left them (a list or
    tuple holds per-field blocks)."""
    q = req.query
    if not isinstance(q, (list, tuple)):
        q = [q]
    out = []
    for f in q:
        if not isinstance(f, torch.Tensor):
            f = torch.as_tensor(np.asarray(f))
        out.append(f if f.dim() == 1 else f.reshape(-1))
    return out


def _concat_to(blocks: list[torch.Tensor], dev: torch.device
               ) -> torch.Tensor:
    """The blocks concatenated as fp32 on ``dev``: one copy when they come
    from one device, one a block when they are mixed."""
    if len({b.device for b in blocks}) == 1:
        return torch.cat(blocks).to(dev, torch.float32)
    return torch.cat([b.to(dev, torch.float32) for b in blocks])


def _resolve_queries(index: ClusterPruneIndex,
                     reqs: Sequence[SearchRequest]) -> torch.Tensor:
    """The unweighted ``(n, D)`` queries of the requests, in order, each
    per-field unit-normalised: the ``like=`` rows in one gather, the raw
    vectors shape-checked on the host, then moved, checked finite with one
    read from the device and normalised together."""
    spec, dev = index.spec, index.docs.device
    likes = [j for j, r in enumerate(reqs) if r.like is not None]
    raw = [j for j, r in enumerate(reqs) if r.like is None]
    parts = []
    if likes:
        ids = [int(reqs[j].like) for j in likes]
        _check_like(index, ids)
        parts.append(index.docs[torch.as_tensor(ids, device=dev)])
    if raw:
        blocks = []
        for j in raw:
            b = _query_blocks(reqs[j])
            dim = sum(x.numel() for x in b)
            if dim != spec.total_dim:
                raise ValueError(
                    f"query has dim {dim}, corpus concat dim is "
                    f"{spec.total_dim} (fields {list(spec.names)} "
                    f"dims {list(spec.dims)})"
                )
            blocks += b
        q = _concat_to(blocks, dev).reshape(len(raw), spec.total_dim)
        count("api.raw_queries", len(raw))
        count("api.resolve_syncs", 1)
        if not bool(torch.isfinite(q).all()):
            raise ValueError(
                "query vector contains non-finite values (NaN/Inf); every "
                "similarity against it would be garbage — fix the embedding "
                "before searching"
            )
        parts.append(normalize_fields(q, spec))
    if len(parts) == 1:
        return parts[0]
    order = np.argsort(likes + raw, kind="stable")
    return torch.cat(parts)[torch.as_tensor(order, device=dev)]


def _first_error(reqs: Sequence[SearchRequest], resolve) -> None:
    """Raise the ``ValueError`` that the first offending request raises
    when resolved alone."""
    for r in reqs:
        try:
            resolve(r)
        except ValueError as err:
            raise err from None


def _check_like(index, likes) -> None:
    bad = [l for l in likes if l >= index.n_docs]
    if bad:
        raise ValueError(
            f"like={bad[0]} out of range for a corpus of "
            f"{index.n_docs} documents"
        )
    if index.removed is not None:
        gone = [l for l in likes if bool(index.removed[l])]
        if gone:
            raise ValueError(
                f"like={gone[0]} refers to a removed document; "
                "more-like-this cannot seed from a tombstoned doc"
            )


@dataclasses.dataclass(frozen=True)
class Hit:
    """One retrieved document: ``score == sum(field_scores.values())``."""

    doc_id: int
    score: float
    field_scores: dict[str, float]


@dataclasses.dataclass(frozen=True, eq=False)
class SearchResponse:
    """Ranked answer to one :class:`SearchRequest`, plus batch stats
    (field meanings as in the reference's ``SearchResponse``)."""

    hits: tuple[Hit, ...]
    doc_ids: np.ndarray      # (k,) int32, -1 padded
    scores: np.ndarray       # (k,) float32, -inf padded
    n_scored: int
    latency_s: float
    backend: str
    probes: int
    batch_size: int
    predicted_recall: float | None = None
    queue_wait_s: float = 0.0
    compute_s: float = 0.0
    tier: str = "approx"
    escalations: int = 0
    degraded: bool = False
    degradation: tuple[str, ...] = ()

    def __len__(self) -> int:
        return len(self.hits)

    def __iter__(self):
        return iter(self.hits)

    @property
    def ids(self) -> list[int]:
        """Doc ids of the valid hits, best first."""
        return [h.doc_id for h in self.hits]


def decompose_scores(qw: torch.Tensor, docs: torch.Tensor, ids: torch.Tensor,
                     spec: FieldSpec) -> torch.Tensor:
    """Split ``qw·p`` over the field blocks: ``(nq, k, s)`` contributions
    that sum to the aggregate score (invalid id slots decompose to 0)."""
    qw = torch.atleast_2d(qw)
    ids = torch.atleast_2d(ids)
    hitvecs = docs[torch.where(ids >= 0, ids, 0).long()]     # (nq, k, D)
    parts = [torch.einsum("qkd,qd->qk", hitvecs[..., sl], qw[..., sl])
             for sl in spec.slices()]
    out = torch.stack(parts, dim=-1)
    return torch.where((ids >= 0)[..., None], out, torch.zeros_like(out))


class Retriever:
    """Facade over index + engines: typed requests in, typed responses out."""

    _QW_CACHE_MAX = 8192
    _RESPONSE_CACHE_MAX = 2048

    def __init__(self, index: ClusterPruneIndex, *, backend: str = "auto",
                 default_probes: int = 12, calibrate: bool = False,
                 calibrate_opts: Mapping | None = None,
                 engine_opts: Mapping | None = None):
        from .engine import pick_backend

        self.index = index
        self.backend = (
            pick_backend(index) if backend in (None, "auto") else backend
        )
        self.default_probes = default_probes
        self.engine_opts = dict(engine_opts or {})
        # calibrate=True: a missing ladder is fitted on the first
        # recall_target= / min_recall= request, and a stale one refitted
        self.calibrate = calibrate
        self.calibrate_opts = dict(calibrate_opts or {})
        t, k_clusters = index.counts.shape
        self._tk = (int(t), int(k_clusters))
        self._plan_cache: dict[float, tuple[int, float]] = {}
        self._plan_ladder = index.ladder
        self._warned_static = False
        self._warned_stale = False
        self._qw_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._response_cache: "OrderedDict[tuple, SearchResponse]" = (
            OrderedDict()
        )
        self._cache_version = index.version

    @classmethod
    def build(cls, docs, spec: FieldSpec, k_clusters: int, *,
              backend: str = "auto", default_probes: int = 12,
              calibrate: bool | Mapping = False,
              calibrate_opts: Mapping | None = None,
              engine_opts: Mapping | None = None,
              **build_kwargs) -> "Retriever":
        """Build the weight-free index (``build_kwargs`` go to
        :meth:`ClusterPruneIndex.build`, e.g. ``pack_dtype=``, ``device=``,
        ``generator=``) and wrap it.

        ``calibrate=True`` (or a dict of
        :func:`~repro_torch.core.calibrate.calibrate_index` options) fits
        the per-index ladder at build time and arms the retriever's refit
        of a stale ladder; ``calibrate_opts`` merge over a ``calibrate``
        dict, and given without opting in they are an error."""
        opted_in = bool(calibrate) or isinstance(calibrate, Mapping)
        opts: dict = dict(calibrate) if isinstance(calibrate, Mapping) else {}
        if calibrate_opts:
            if not opted_in:
                raise ValueError(
                    "calibrate_opts= was given but calibrate= is off; pass "
                    "calibrate=True (or a dict of options) to opt in"
                )
            opts.update(calibrate_opts)
        index = ClusterPruneIndex.build(
            docs, spec, k_clusters,
            calibrate=(opts or True) if opted_in else False, **build_kwargs)
        return cls(index, backend=backend, default_probes=default_probes,
                   calibrate=opted_in, calibrate_opts=opts,
                   engine_opts=engine_opts)

    @property
    def spec(self) -> FieldSpec:
        return self.index.spec

    # ------------------------------------------------------------- mutation
    def add(self, new_docs) -> np.ndarray:
        """Ingest documents into the served index (no rebuild); returns the
        new doc ids. Goes through
        :meth:`~repro_torch.core.index.ClusterPruneIndex.add_documents` and
        flushes every request cache: the next request sees the mutated
        corpus."""
        ids = self.index.add_documents(new_docs)
        self._flush_request_caches()
        return ids

    def remove(self, doc_ids) -> int:
        """Tombstone documents out of the served index; returns how many
        were newly removed. The ids never appear in a hit again."""
        n = self.index.remove_documents(doc_ids)
        self._flush_request_caches()
        return n

    # long-form aliases matching the index methods
    add_documents = add
    remove_documents = remove

    def _flush_request_caches(self) -> None:
        self._qw_cache.clear()
        self._response_cache.clear()
        self._plan_cache.clear()
        self._cache_version = self.index.version

    def _sync_version(self) -> None:
        """Cached responses never outlive an index mutation, nor a ladder
        swapped on the index directly (``calibrate_index``)."""
        if self.index.version != self._cache_version:
            self._flush_request_caches()
        if self.index.ladder is not self._plan_ladder:
            self._plan_cache.clear()
            self._response_cache.clear()
            self._plan_ladder = self.index.ladder

    @staticmethod
    def _weights_key(weights):
        if weights is None:
            return None
        if isinstance(weights, Mapping):
            return tuple(sorted((str(k), float(v)) for k, v in weights.items()))
        return tuple(float(v) for v in np.asarray(weights).reshape(-1))

    def _request_key(self, req: SearchRequest) -> tuple | None:
        """Full identity of a more-like-this request (raw query vectors are
        not memoised)."""
        if req.like is None:
            return None
        probes = req.probes
        if probes is None and req.recall_target is None:
            probes = self.default_probes
        return (int(req.like), self._weights_key(req.weights), req.k, probes,
                req.recall_target, req.exclude, req.backend or self.backend,
                req.rescore, req.exact, req.min_recall)

    @staticmethod
    def _cache_put(cache, cap, key, value) -> None:
        cache[key] = value
        while len(cache) > cap:
            cache.popitem(last=False)

    def exec_shape(self, req: SearchRequest) -> ExecShape:
        """This request's :class:`ExecShape` under this retriever: its
        default backend and probes, its calibrated planner, the index's
        T·K ceiling and its ladder's recall predictor."""
        if (req.min_recall is not None and self.calibrate
                and (self.index.ladder is None or self.index.ladder_stale)):
            # a floor gets the same lazy fit / refit a target gets
            self._plan_target(req.min_recall)
        return exec_shape(
            req,
            default_backend=self.backend,
            default_probes=self.default_probes,
            plan_target=lambda t: self._plan_target(t)[0],
            total_probes=self._tk[0] * self._tk[1],
            predict_recall=self._predict_recall,
        )

    def _plan(self, req: SearchRequest) -> tuple[ExecShape, float | None]:
        shape = self.exec_shape(req)
        if shape.tier == "exact":
            return shape, 1.0
        if req.recall_target is not None and req.probes is None:
            return shape, self._plan_target(req.recall_target)[1]
        return shape, self._predict_recall(shape.probes)

    def _predict_recall(self, probes: int) -> float | None:
        """Fitted CR/k at a budget; None without a ladder."""
        ladder = self.index.ladder
        return None if ladder is None else float(
            ladder.predicted_recall(probes))

    def _plan_target(self, target: float) -> tuple[int, float]:
        """recall_target -> (probes, predicted recall), cached: from the
        index's calibrated ladder (fitted here with ``calibrate=True`` when
        missing or stale; a stale one otherwise plans with a one-time
        warning), else from the static ladder with a one-time warning (the
        target is then nominal, not measured)."""
        ladder = self.index.ladder
        stale = self.index.ladder_stale
        if (ladder is None or stale) and self.calibrate:
            from .calibrate import calibrate_index

            ladder = calibrate_index(self.index, **self.calibrate_opts)
        elif stale and not self._warned_stale:
            warnings.warn(
                "the index's calibrated probe ladder is stale (corpus churn "
                "since calibration exceeds the drift threshold); "
                "recall_target planning still uses it, but re-run "
                "repro_torch.core.calibrate_index(index), or construct the "
                "Retriever with calibrate=True to refit automatically.",
                stacklevel=3,
            )
            self._warned_stale = True
        if ladder is not self._plan_ladder:       # fitted/replaced: re-plan
            self._plan_cache.clear()
            self._response_cache.clear()
            self._plan_ladder = ladder
        cached = self._plan_cache.get(target)
        if cached is not None:
            return cached
        if ladder is not None:
            probes = ladder.plan(target)
            plan = (probes, float(ladder.predicted_recall(probes)))
        else:
            if not self._warned_static:
                warnings.warn(
                    "index has no calibrated probe ladder; recall_target "
                    "planning falls back to the static _RECALL_LADDER, "
                    "which was fit on one synthetic corpus and one weight "
                    "setting — the target is nominal, not measured. Build "
                    "with calibrate=True or run "
                    "repro_torch.core.calibrate_index(index).",
                    stacklevel=3,
                )
                self._warned_static = True
            t, k_clusters = self._tk
            plan = (plan_probes(target, t, k_clusters), float(target))
        self._plan_cache[target] = plan
        return plan

    def search(self, request: SearchRequest | Iterable[SearchRequest]
               ) -> SearchResponse | list[SearchResponse]:
        """Serve one request or a heterogeneous batch (responses in order)."""
        if isinstance(request, SearchRequest):
            return self._search_batch([request])[0]
        return self._search_batch(list(request))

    def _resolve_qw(self, mreqs: list[SearchRequest]) -> torch.Tensor:
        """``(n, D)`` weighted queries of the requests: memoised per
        ``(like, weights)``, the rest resolved together (one gather, one
        validity read for the raw vectors, one weight check) into one
        ``weighted_query`` call.

        A bad batch raises what resolving its requests one at a time
        raises: the first offending query, then the first offending
        weights (an all-``like=`` batch checks its ids together)."""
        index, spec = self.index, self.spec
        qkeys = [
            (int(r.like), self._weights_key(r.weights))
            if r.like is not None else None
            for r in mreqs
        ]
        rows = [self._qw_cache.get(qk) if qk is not None else None
                for qk in qkeys]
        todo = [j for j, row in enumerate(rows) if row is None]
        if todo:
            treqs = [mreqs[j] for j in todo]
            try:
                q_all = _resolve_queries(index, treqs)
            except ValueError:
                if any(r.like is None for r in treqs):
                    _first_error(treqs, lambda r: r.resolve_query(index))
                raise
            try:
                w_rows = validate_weights(_weight_rows(spec, treqs), spec)
            except ValueError:
                _first_error(treqs, lambda r: r.resolve_weights(spec))
                raise
            qw_new = weighted_query(q_all, torch.as_tensor(w_rows), spec)
            for jj, j in enumerate(todo):
                rows[j] = qw_new[jj]
                if qkeys[j] is not None:
                    self._cache_put(self._qw_cache, self._QW_CACHE_MAX,
                                    qkeys[j], qw_new[jj])
            if len(todo) == len(mreqs):      # cold batch: already stacked
                return qw_new
        return torch.stack(rows)

    def _search_batch(self, reqs: list[SearchRequest]) -> list[SearchResponse]:
        from .engine import get_engine

        if not reqs:
            return []
        self._sync_version()
        index, spec = self.index, self.spec
        with span("api.resolve"):
            keys = [self._request_key(r) for r in reqs]
            out: list[SearchResponse | None] = [
                self._response_cache.get(key) if key is not None else None
                for key in keys
            ]
            miss = [i for i, resp in enumerate(out) if resp is None]
            if not miss:
                return out  # type: ignore[return-value]
            mreqs = [reqs[i] for i in miss]
            qw_all = self._resolve_qw(mreqs)
            excl_all = np.asarray([r.resolve_exclude() for r in mreqs],
                                  np.int32)
        with span("api.plan"):
            plans = [self._plan(r) for r in mreqs]
            groups: dict[ExecShape, list[int]] = {}
            for j, (shape, _) in enumerate(plans):
                groups.setdefault(shape, []).append(j)

        dev = index.docs.device
        for shape, rows in groups.items():
            backend, probes, k, rescore = (
                shape.backend, shape.probes, shape.k, shape.rescore,
            )
            opts = self.engine_opts if backend == self.backend else {}
            engine = get_engine(index, backend, **opts)
            sel = torch.as_tensor(rows, device=dev)
            qw = qw_all[sel]
            excl = torch.as_tensor(excl_all[rows], device=dev)
            t0 = time.perf_counter()
            tier, escalations, pred_served = "approx", 0, None
            if shape.tier == "exact":
                scores, ids, n_scored = engine.search_exact(
                    qw, k=k, exclude=excl, rescore=rescore)
                tier, pred_served = "exact", 1.0
            elif shape.tier == "escalate":
                scores, ids, n_scored, info = engine.search_escalating(
                    qw, probes=probes, k=k, min_recall=shape.min_recall,
                    exclude=excl, rescore=rescore)
                tier = info["tier"]
                escalations = info["escalations"]
                probes = info["probes"]
                pred_served = info["predicted_recall"]
            else:
                scores, ids, n_scored = engine.search(
                    qw, probes=probes, k=k, exclude=excl, rescore=rescore)
            if dev.type == "cuda":
                # this thread's stream only: a serving replica's compute_s
                # must not wait for another replica's kernels
                torch.cuda.current_stream(dev).synchronize()
            with span("api.respond"):
                fields = decompose_scores(qw, index.docs, ids, spec)
                scores_np = scores.cpu().numpy().astype(np.float32)
                ids_np = ids.cpu().numpy().astype(np.int32)
                n_np = n_scored.cpu().numpy().astype(np.int32)
                fields_np = fields.cpu().numpy().astype(np.float32)
                dt = time.perf_counter() - t0
                if profiling():      # n_live sums the tombstone mask
                    count("api.scored", n_np.sum())
                    count("api.candidates", len(rows) * index.n_live)
                for jj, j in enumerate(rows):
                    hits = tuple(
                        Hit(
                            doc_id=int(ids_np[jj, c]),
                            score=float(scores_np[jj, c]),
                            field_scores={
                                name: float(fields_np[jj, c, f])
                                for f, name in enumerate(spec.names)
                            },
                        )
                        for c in range(ids_np.shape[1])
                        if ids_np[jj, c] >= 0
                    )
                    resp = SearchResponse(
                        hits=hits,
                        doc_ids=ids_np[jj],
                        scores=scores_np[jj],
                        n_scored=int(n_np[jj]),
                        latency_s=dt,
                        backend=engine.name,
                        probes=probes,
                        batch_size=len(rows),
                        predicted_recall=(
                            pred_served if pred_served is not None
                            else plans[j][1]
                        ),
                        queue_wait_s=0.0,
                        compute_s=dt,
                        tier=tier,
                        escalations=escalations,
                    )
                    i = miss[j]
                    out[i] = resp
                    if keys[i] is not None:
                        resp.doc_ids.flags.writeable = False
                        resp.scores.flags.writeable = False
                        self._cache_put(self._response_cache,
                                        self._RESPONSE_CACHE_MAX, keys[i],
                                        resp)
        return out  # type: ignore[return-value]

"""Per-index planner calibration — an honest ``recall_target=`` contract
(port of :mod:`repro.core.calibrate`).

The static :data:`repro_torch.core.api._RECALL_LADDER` was fit once, on one
synthetic corpus, under one weight setting. But the recall-vs-probes curve
depends strongly on the clustering at hand *and* on the user's weight vector
(Chierichetti et al., PODS'07): the same probe budget that delivers 0.9
recall on a balanced FPF clustering can deliver 0.5 on a skewed one. A
``recall_target=`` knob backed by a constant ladder therefore silently lies
on any index it was not fit on.

This module fits the ladder **per index**, on the index's own data:

1. **Sample** held-out query documents from the corpus (self-excluded, so
   the query never votes for itself) and random Dirichlet weight draws —
   the paper's *dynamic user-defined* setting, where the weights are not
   known at index-build time, is exactly why the fit must marginalise over
   weight draws instead of assuming one.
2. **Sweep** a probe grid through the engine seam
   (:func:`repro_torch.core.engine.sweep_probes` — one engine, one bucket-major
   pack, reused across every level) and score each level's competitive
   recall against ground truth from the SAME engine's exact tier
   (``search_exact`` — the clustered full sweep, id-identical to
   ``brute_force_topk`` on every backend): buckets already exclude
   tombstones and quantised packs route through the fp32 rescore tail, so
   no separate brute-force pass or live-mask bookkeeping is needed.
3. **Fit** an isotonic (pool-adjacent-violators) regression of mean recall
   on probes. Monotonicity is a *property of the true curve* (more probes
   can only add candidates), so isotonising removes sampling noise without
   bias, and makes :meth:`ProbeLadder.plan` monotone in the target by
   construction.

The fitted :class:`ProbeLadder` is stored on the index (``index.ladder``),
serialized with it (:meth:`repro_torch.core.index.ClusterPruneIndex.save`,
in the reference's JSON layout, so a ladder carries across the ``.npz``
both ways), and consulted by ``Retriever._plan``. The queries and weight
draws come from ``np.random.default_rng(seed)`` exactly as the reference
draws them, so one seed samples the same calibration set in both packages.

The measured recall of a rung is the exact mean (:func:`exact_mean_recall`):
the integer count of hits over the batch divided by ``k·nq`` in float64 and
rounded once to float32. It does not depend on the device or on the order
of the queries, so the card and the CPU fit the same ladder bit for bit.
The reference takes ``jnp.mean`` of per-query fractions in float32, whose
summation order no fixed order reproduces; the two packages' rungs
therefore agree only to within a few float32 ulps (2 ulps of 1.0, before
and after :func:`isotonic_fit`; tests/test_torch_calibrate.py pins it), and
a ``recall_target`` that falls between the two values of a rung may plan
one rung apart.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = ["ProbeLadder", "calibrate_index", "exact_mean_recall",
           "isotonic_fit"]


def isotonic_fit(y: Sequence[float], w: Sequence[float] | None = None) -> np.ndarray:
    """Weighted isotonic (non-decreasing) regression by pool-adjacent-violators.

    Returns the least-squares non-decreasing fit to ``y``. Used to turn the
    noisy measured recall-vs-probes points into a monotone ladder; no
    external dependency (sklearn is not in the container).
    """
    y = np.asarray(y, np.float64)
    w = np.ones_like(y) if w is None else np.asarray(w, np.float64)
    if y.ndim != 1 or y.shape != w.shape:
        raise ValueError(f"y and w must be 1-D and equal length, got {y.shape} / {w.shape}")
    # blocks of (value, weight, count), merged while the order is violated
    blocks: list[list[float]] = []
    for yi, wi in zip(y, w):
        blocks.append([float(yi), float(wi), 1])
        while len(blocks) > 1 and blocks[-2][0] > blocks[-1][0]:
            v2, w2, c2 = blocks.pop()
            v1, w1, c1 = blocks.pop()
            tot = w1 + w2
            blocks.append([(v1 * w1 + v2 * w2) / tot, tot, c1 + c2])
    out = np.empty_like(y)
    i = 0
    for v, _, c in blocks:
        out[i:i + c] = v
        i += c
    return out


def exact_mean_recall(ret_ids: torch.Tensor, gt_ids: torch.Tensor) -> float:
    """Mean ``CR/k`` over a batch, exactly: the integer number of hits
    divided by ``k·nq`` in float64, rounded once to float32 (a value that
    no reduction order or device can change)."""
    from .metrics import competitive_recall

    hits = int(competitive_recall(ret_ids, gt_ids).to(torch.int64).sum())
    nq, k = (int(x) for x in gt_ids.shape)
    return float(np.float32(hits / (k * nq)))


@dataclasses.dataclass(frozen=True)
class ProbeLadder:
    """A fitted, monotone recall -> probe-budget map for ONE built index.

    ``probes[i]`` is an ascending grid of total probe budgets; ``recall[i]``
    is the isotonic-fitted mean competitive-recall fraction (CR/k in [0, 1])
    measured at that budget on this index, marginalised over random weight
    draws. ``plan`` inverts the curve (smallest budget whose fitted recall
    meets the target); ``predicted_recall`` evaluates it, so planner output
    can be audited against achieved recall downstream.
    """

    probes: tuple[int, ...]
    recall: tuple[float, ...]
    n_clusterings: int            # T of the index this was fit on
    k_clusters: int               # K of the index this was fit on
    meta: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if len(self.probes) != len(self.recall) or not self.probes:
            raise ValueError("probes and recall must be equal-length, non-empty")
        if list(self.probes) != sorted(set(self.probes)):
            raise ValueError(f"probes must be strictly ascending, got {self.probes}")
        if any(b - a < -1e-9 for a, b in zip(self.recall, self.recall[1:])):
            raise ValueError(f"recall must be non-decreasing (isotonic), got {self.recall}")

    @property
    def total(self) -> int:
        """T*K — the exact-search probe budget."""
        return self.n_clusterings * self.k_clusters

    def plan(self, recall_target: float) -> int:
        """Smallest measured budget whose fitted recall meets the target.

        Monotone in the target (the fitted curve is non-decreasing); targets
        above the fitted maximum degrade to ``T*K`` = exact search, clamped
        to ``[T, T*K]`` like the static ladder.
        """
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        budget = self.total
        for p, r in zip(self.probes, self.recall):
            if r >= recall_target - 1e-9:
                budget = p
                break
        return max(self.n_clusterings, min(self.total, int(budget)))

    def predicted_recall(self, probes: int) -> float:
        """Fitted recall fraction at a probe budget (linear interpolation).

        ``probes >= T*K`` is exact search -> 1.0 regardless of the fit;
        budgets below the smallest calibrated rung interpolate toward
        ``(0 probes, 0 recall)`` instead of clamping to the first rung,
        which would over-promise for tiny explicit ``probes=`` budgets.
        """
        if probes >= self.total:
            return 1.0
        xs = np.asarray((0,) + self.probes, np.float64)
        ys = np.asarray((0.0,) + self.recall, np.float64)
        return float(min(1.0, max(0.0, np.interp(probes, xs, ys))))

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> dict:
        return {
            "probes": list(self.probes),
            "recall": [float(r) for r in self.recall],
            "n_clusterings": self.n_clusterings,
            "k_clusters": self.k_clusters,
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ProbeLadder":
        return cls(
            probes=tuple(int(p) for p in d["probes"]),
            recall=tuple(float(r) for r in d["recall"]),
            n_clusterings=int(d["n_clusterings"]),
            k_clusters=int(d["k_clusters"]),
            meta=dict(d.get("meta", {})),
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path) -> "ProbeLadder":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def default_probe_grid(n_clusterings: int, k_clusters: int) -> tuple[int, ...]:
    """Probe grid for calibration: log-ish coverage of [T, T*K].

    Dense at small budgets (where the recall curve bends) and capped at half
    the clusters — past that the curve is flat-near-1 and a sweep level costs
    as much as exact search; targets the fit cannot reach plan to ``T*K``.
    """
    total = n_clusterings * k_clusters
    fracs = (0.02, 0.04, 0.08, 0.14, 0.22, 0.35, 0.5)
    grid = sorted({
        min(total, max(n_clusterings, math.ceil(f * total))) for f in fracs
    })
    return tuple(grid)


def calibrate_index(
    index,
    *,
    n_queries: int = 64,
    n_weight_draws: int = 6,
    k: int = 10,
    probe_grid: Sequence[int] | None = None,
    seed: int = 0,
    backend: str | None = None,
    engine_opts: Mapping | None = None,
    rescore: int | None = None,
    store: bool = True,
) -> ProbeLadder:
    """Fit a :class:`ProbeLadder` for one built index (sample -> sweep -> fit).

    ``n_queries`` documents are sampled as held-out more-like-this queries
    (each excludes itself from its own ground truth and answer — the sampled
    document never contributes to its own recall), crossed with
    ``n_weight_draws`` random Dirichlet weight vectors so the fit
    marginalises over the paper's query-time user weights. The sweep runs
    through :func:`repro_torch.core.engine.sweep_probes` on ``backend``
    (None = device auto-pick) — quality is mechanism-independent (backend
    parity is enforced by tests/test_torch_slice.py), so the cheapest
    available engine gives the same curve; ``engine_opts`` (e.g. ``{"query_tile": 16}`` for
    the fused backend) pass through to the sweep's engine resolution, which
    reuses opts-keyed cached engines across levels and repeat calibrations.
    ``rescore`` applies the exact-rescore tail at every sweep level — an
    index served with ``SearchRequest(rescore=...)`` (e.g. an int8 pack
    behind a rescored cut) should calibrate on the curve it will actually
    serve; the depth is recorded in the ladder's ``meta``.

    ``store=True`` (default) attaches the ladder to ``index.ladder``, where
    ``Retriever._plan`` and ``ClusterPruneIndex.save`` pick it up, and
    resets the index's mutation-drift counter — a freshly fitted ladder is
    by definition not stale (see ``ClusterPruneIndex.ladder_stale``).
    On a mutated index, queries are sampled from LIVE documents only;
    ground truth comes from the engine's own exact tier, whose bucket
    sweep can never surface a tombstoned document, so no separate
    removed-mask bookkeeping is needed (and the curve stays unbiased).
    """
    from .engine import (
        _SWEEP_GATHER_BYTES, get_engine, pick_backend, sweep_probes,
    )
    from .weights import weighted_query

    docs, spec = index.docs, index.spec
    t, kc = (int(x) for x in index.counts.shape)
    grid = (
        default_probe_grid(t, kc) if probe_grid is None
        else tuple(sorted({int(p) for p in probe_grid}))
    )
    if not grid:
        raise ValueError("probe_grid must be non-empty")

    rng = np.random.default_rng(seed)
    removed = getattr(index, "removed", None)
    live = (
        np.flatnonzero(~removed) if removed is not None
        else np.arange(index.n_docs)
    )
    nq = min(n_queries, live.size)
    qids = rng.choice(live, nq, replace=False)
    # Weight draws must cover the simplex CORNERS, not just its middle:
    # skewed weights (one dominant field) are the hard cases — the query
    # collapses toward one subspace while the clustering was built on the
    # full concatenation — and a handful of Dirichlet(1) draws rarely lands
    # there, which yields an optimistic ladder. Half the draws are therefore
    # sampled spiky (alpha < 1) so the marginalised curve prices them in.
    half = n_weight_draws // 2
    w = np.concatenate([
        rng.dirichlet(np.ones(spec.s), size=n_weight_draws - half),
        rng.dirichlet(np.full(spec.s, 0.3), size=half),
    ]).astype(np.float32)

    # All (draw, query) pairs as one batch: queries tile, weights repeat.
    dev = docs.device
    q = index.docs[torch.as_tensor(qids, device=dev)]     # (nq, D)
    q_all = q.repeat(n_weight_draws, 1)                   # (R*nq, D)
    w_all = torch.as_tensor(np.repeat(w, nq, axis=0))     # (R*nq, s)
    qw = weighted_query(q_all, w_all, spec)
    exclude = torch.as_tensor(np.tile(qids, n_weight_draws).astype(np.int32),
                              device=dev)

    # Ground truth from the exact tier of the SAME seam the sweep runs on:
    # the clustered full sweep is id-identical to brute_force_topk (the
    # quantised fused pack via its forced fp32 rescore), and its bucket
    # walk can never surface a tombstoned doc. The reference backend's
    # query chunk shrinks like sweep_probes' per-level rule, at the T·K
    # budget, so the (qchunk, candidates, D) gather stays bounded.
    name = pick_backend(index) if backend in (None, "auto") else backend
    gt_opts = dict(engine_opts or {})
    if name == "reference" and "qchunk" not in gt_opts:
        b = int(index.buckets.shape[-1])
        d = int(docs.shape[-1])
        gt_opts["qchunk"] = int(max(
            1, min(8, _SWEEP_GATHER_BYTES // max(1, t * kc * b * d * 4))
        ))
    _, gt_ids, _ = get_engine(index, name, **gt_opts).search_exact(
        qw, k=k, exclude=exclude
    )

    sweep = sweep_probes(
        index, qw, probe_grid=grid, k=k, exclude=exclude, backend=backend,
        engine_opts=engine_opts, rescore=rescore,
    )
    measured = [exact_mean_recall(ids, gt_ids) for _, ids, _ in sweep]
    fitted = np.clip(isotonic_fit(measured), 0.0, 1.0)

    ladder = ProbeLadder(
        probes=grid,
        recall=tuple(float(r) for r in fitted),
        n_clusterings=t,
        k_clusters=kc,
        meta={
            "n_queries": int(nq),
            "n_weight_draws": int(n_weight_draws),
            "k": int(k),
            "seed": int(seed),
            "backend": backend or "auto",
            "rescore": None if rescore is None else int(rescore),
            "measured_recall": [float(r) for r in measured],
        },
    )
    if store:
        index.ladder = ladder
        index.n_mutations = 0     # fresh fit == zero drift by definition
    return ladder

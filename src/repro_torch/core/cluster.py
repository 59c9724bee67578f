"""Pluggable clusterer layer — the build side of the index (port of
:mod:`repro.core.cluster`).

``fpf``
    The paper's clusterer: Gonzalez furthest-point-first on a
    ``ceil(sqrt(K·n))`` sample with plain PyTorch rounds
    (:func:`fpf_centers`), then the shared assignment + medoid tail.
``fpf_fused``
    The same algorithm with every round driven through the ``fpf_iter``
    kernel (one CUDA launch for all the rounds on the card, its plain
    version on the CPU);
    :func:`pick_clusterer` picks it for data on a CUDA device, as the
    reference picks it on a TPU.
``kmeans``
    Full-corpus spherical Lloyd — CellDec's clusterer [Singitham et al.
    VLDB'04], the expensive baseline of Table 1.
``random``
    PODS'07 random leaders with centroid representatives [Chierichetti et
    al.], the cheap baseline.

All of them finalise through one assignment + representative-adjust tail
(:func:`assign_refine`, medoid or centroid updates). Its sums per cluster
run in a fixed order on every device (a stable sort by cluster, then a
segmented sum in row order), so a build repeated on the card gives the same
index bit for bit; ``index_add_`` would add with atomics there.

Randomness: the reference draws with ``jax.random.permutation`` and
``jax.random.randint``, which PyTorch cannot replay. The port draws from a
``torch.Generator`` (on the CPU, so a seed gives the same draws on every
device), so the two packages build DIFFERENT indexes from the same seed.
For parity tests the draws can be given: ``sample_idx=``/``first=`` for
FPF, ``init_idx=`` for k-means, ``leader_idx=`` for random leaders.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

__all__ = [
    "ClusteringResult",
    "Clusterer",
    "CLUSTERERS",
    "register_clusterer",
    "available_clusterers",
    "pick_clusterer",
    "get_clusterer",
    "fpf_centers",
    "fpf_sample_size",
    "assign_to_centers",
    "assign_to_centers_multi",
    "assign_refine",
    "FPFClusterer",
    "FusedFPFClusterer",
    "KMeansClusterer",
    "RandomLeaderClusterer",
    "fpf_cluster",
    "kmeans_cluster",
    "random_leader_cluster",
]


@dataclasses.dataclass
class ClusteringResult:
    """Output of any registered clusterer."""

    assign: torch.Tensor      # (n,) int32 cluster id per point
    reps: torch.Tensor        # (K, D) representative per cluster (unit norm)
    counts: torch.Tensor      # (K,) points per cluster (float, as the reference)
    max_radius: torch.Tensor  # () max cosine distance of a point to its rep

    @property
    def k(self) -> int:
        return self.reps.shape[0]


@runtime_checkable
class Clusterer(Protocol):
    """What every registered clusterer provides: one full clustering."""

    name: str

    def cluster(self, x: torch.Tensor, k: int,
                generator: torch.Generator | None = None
                ) -> ClusteringResult:
        ...


CLUSTERERS: dict[str, type] = {}


def register_clusterer(name: str):
    """Class decorator: register a :class:`Clusterer` implementation."""

    def deco(cls):
        cls.name = name
        CLUSTERERS[name] = cls
        return cls

    return deco


def available_clusterers() -> tuple[str, ...]:
    return tuple(CLUSTERERS)


def pick_clusterer(device=None) -> str:
    """``fpf_fused`` for data on a CUDA device (the rounds run in the
    CUDA ``fpf_iter`` kernel), ``fpf`` otherwise."""
    if device is None:
        return "fpf"
    return "fpf_fused" if torch.device(device).type == "cuda" else "fpf"


def get_clusterer(name: str = "auto", *, device=None, **opts) -> Clusterer:
    """Clusterer instance by registry name (``"auto"`` = device pick)."""
    resolved = pick_clusterer(device) if name in (None, "auto") else name
    if resolved not in CLUSTERERS:
        raise ValueError(
            f"unknown clusterer {name!r}; available: {sorted(CLUSTERERS)}"
        )
    return CLUSTERERS[resolved](**opts)


# ------------------------------------------------------- shared primitives
def fpf_sample_size(k: int, n: int) -> int:
    """``ceil(sqrt(k·n))`` computed in float32, as the reference computes it
    (JAX runs with 64-bit floats off)."""
    return int(np.ceil(np.sqrt(np.float32(k * n), dtype=np.float32)))


def fpf_centers(x: torch.Tensor, k: int, first) -> torch.Tensor:
    """Gonzalez FPF on unit-norm points ``x (m, D)`` -> ``(k,)`` int32 center
    indices, starting from row ``first``; plain PyTorch rounds. ``maxsim``
    holds every point's max similarity to the chosen centers and the next
    center is its first argmin."""
    m = x.shape[0]
    idxs = torch.zeros((k,), dtype=torch.int32, device=x.device)
    idxs[0] = int(first)
    maxsim = torch.full((m,), float("-inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        sim = torch.mv(x, x[idxs[i - 1].long()])
        maxsim = torch.maximum(maxsim, sim)
        idxs[i] = torch.argmin(maxsim).to(torch.int32)
    return idxs


def assign_to_centers(
    x: torch.Tensor, reps: torch.Tensor, *, chunk: int = 16384
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign every point to its most similar representative (first argmax
    on ties): ``(assign (n,) int32, sim (n,))``."""
    a, s = assign_to_centers_multi(x, reps[None], chunk=chunk)
    return a[0], s[0]


def assign_to_centers_multi(
    x: torch.Tensor, leaders: torch.Tensor, *, chunk: int = 16384
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign every point under all T clusterings with one fp32 matmul per
    row chunk against the flattened ``(T·K, D)`` leaders:
    ``(assign (T, n) int32, sim (T, n))``."""
    t, k, d = leaders.shape
    flat = leaders.reshape(t * k, d)
    a_parts, s_parts = [], []
    for i in range(0, x.shape[0], chunk):
        sims = (x[i:i + chunk] @ flat.T).reshape(-1, t, k)
        # argmax returns the first index among ties (jnp.argmax's rule);
        # torch.max(dim=) promises no such order
        a_parts.append(torch.argmax(sims, dim=-1).to(torch.int32))
        s_parts.append(torch.amax(sims, dim=-1))
    return torch.cat(a_parts).T.contiguous(), torch.cat(s_parts).T.contiguous()


def _cluster_sums(x: torch.Tensor, a: torch.Tensor, counts: torch.Tensor
                  ) -> torch.Tensor:
    """``(k, D)`` sum of each cluster's rows, in row order within a
    cluster on every device (stable sort + segmented sum); an empty
    cluster sums to 0."""
    order = torch.sort(a, stable=True).indices
    return torch.segment_reduce(x[order], "sum",
                                lengths=counts.to(torch.int64), axis=0)


def _centroids(x: torch.Tensor, assign: torch.Tensor, k: int,
               prev: torch.Tensor) -> torch.Tensor:
    """Unit-normalised per-cluster centroid; empty clusters keep ``prev``.
    Sums in a fixed order (:func:`_cluster_sums`)."""
    a = assign.long()
    counts = torch.bincount(a, minlength=k)
    cent = _cluster_sums(x, a, counts)
    norm = torch.linalg.vector_norm(cent, dim=-1, keepdim=True)
    return torch.where(counts[:, None] > 0,
                       cent / torch.clamp(norm, min=1e-12), prev)


def _medoids(
    x: torch.Tensor, assign: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster medoid = the member most similar to the normalised
    centroid; the first such member within ``1e-7`` of the best wins, and an
    empty cluster takes row ``n - 1`` (the reference's clip).

    The centroid sums run in a fixed order on every device — a stable sort
    by cluster, then a segmented sum over each cluster's rows in row order
    (the order of the reference's ``segment_sum``) — so a build repeated on
    the card picks the same medoids; ``index_add_`` would add with atomics
    there, in an order that changes from run to run."""
    n = x.shape[0]
    a = assign.long()
    counts = torch.bincount(a, minlength=k).to(x.dtype)
    cent = _cluster_sums(x, a, counts)
    norm = torch.linalg.vector_norm(cent, dim=-1, keepdim=True)
    cent = cent / torch.clamp(norm, min=1e-12)
    score = torch.sum(x * cent[a], dim=-1)
    best = torch.full((k,), float("-inf"), dtype=x.dtype, device=x.device)
    best = best.scatter_reduce(0, a, score, "amax", include_self=False)
    is_best = score >= best[a] - 1e-7
    rows = torch.arange(n, device=x.device)
    cand = torch.where(is_best, rows, n)
    medoid = torch.full((k,), n, dtype=torch.int64, device=x.device)
    medoid = medoid.scatter_reduce(0, a, cand, "amin", include_self=False)
    medoid = torch.clamp(medoid, 0, n - 1)
    return x[medoid], counts


def assign_refine(
    x: torch.Tensor,
    k: int,
    reps: torch.Tensor,
    *,
    refine_iters: int = 0,
    rep_update: str = "medoid",
    chunk: int = 16384,
) -> ClusteringResult:
    """The shared assignment + representative-adjust tail: assign, then
    ``refine_iters`` rounds of representative adjustment (``"medoid"``, the
    paper's FPF pipeline, or ``"centroid"``, Lloyd) each followed by
    re-assignment, so ``assign`` is consistent with ``reps``."""
    if rep_update not in ("medoid", "centroid"):
        raise ValueError(
            f"rep_update must be 'medoid' or 'centroid', got {rep_update!r}"
        )
    assign, sim = assign_to_centers(x, reps, chunk=chunk)
    for _ in range(refine_iters):
        if rep_update == "medoid":
            reps, _ = _medoids(x, assign, k)
        else:
            reps = _centroids(x, assign, k, reps)
        assign, sim = assign_to_centers(x, reps, chunk=chunk)
    counts = torch.bincount(assign.long(), minlength=k).to(x.dtype)
    return ClusteringResult(
        assign=assign, reps=reps, counts=counts, max_radius=1.0 - sim.min()
    )


# ---------------------------------------------------------------- clusterers
def _draw(generator, n: int, k: int, given, device) -> torch.Tensor:
    """``given`` indices, or the first ``k`` of a random permutation of
    ``n`` drawn from ``generator`` (seed 0 when None), on ``device``."""
    if given is None:
        g = generator
        if g is None:
            g = torch.Generator().manual_seed(0)
        return torch.randperm(n, generator=g)[:k].to(device)
    return torch.as_tensor(np.array(given), dtype=torch.int64).to(device)


class _ClustererBase:
    """Shared option plumbing for registered clusterers."""

    def __init__(self, *, chunk: int = 16384):
        self.chunk = chunk

    def cluster(self, x, k, generator=None) -> ClusteringResult:
        raise NotImplementedError


@register_clusterer("fpf")
class FPFClusterer(_ClustererBase):
    """The paper's pipeline for ONE clustering: sample ``ceil(sqrt(k·n))``
    points without replacement, FPF on the sample, assign every point to
    its nearest center, ``refine_iters`` rounds of medoid adjustment."""

    def __init__(self, *, sample_size: int | None = None,
                 refine_iters: int = 1, chunk: int = 16384):
        super().__init__(chunk=chunk)
        self.sample_size = sample_size
        self.refine_iters = refine_iters

    def _centers(self, xs: torch.Tensor, k: int, first: int) -> torch.Tensor:
        """The FPF rounds themselves — ``fpf_fused`` overrides only this."""
        return fpf_centers(xs, k, first)

    def cluster(self, x, k, generator=None, *, sample_idx=None, first=None
                ) -> ClusteringResult:
        """Cluster unit-norm ``x (n, D)`` into ``k`` groups.

        The sample and the first center are drawn from ``generator`` (a CPU
        ``torch.Generator``; seed 0 when None) unless given: ``sample_idx``
        (indices into ``x``) and ``first`` (an index into the sample) let a
        test replay the reference's draws.
        """
        n = x.shape[0]
        g = generator
        if g is None and (sample_idx is None or first is None):
            g = torch.Generator().manual_seed(0)
        if sample_idx is None:
            size = self.sample_size
            if size is None:
                size = fpf_sample_size(k, n)
            size = max(min(size, n), k)
            sample_idx = torch.randperm(n, generator=g)[:size]
        sample_idx = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64
                                     ).to(x.device)
        if first is None:
            first = int(torch.randint(0, sample_idx.numel(), (1,),
                                      generator=g))
        xs = x[sample_idx].contiguous()
        centers = self._centers(xs, k, int(first))
        reps = x[sample_idx[centers.long()]]
        return assign_refine(
            x, k, reps, refine_iters=self.refine_iters, rep_update="medoid",
            chunk=self.chunk,
        )


@register_clusterer("fpf_fused")
class FusedFPFClusterer(FPFClusterer):
    """FPF with every Gonzalez round driven through the ``fpf_iter`` kernel
    (:func:`repro_torch.kernels.fpf_iter.fpf_centers_fused`): one CUDA
    launch for all the rounds for data on the card, its plain version for
    data on the CPU.
    Same sampling, tail and tie rules as ``fpf``."""

    def _centers(self, xs, k, first):
        from ..kernels.fpf_iter import fpf_centers_fused

        return fpf_centers_fused(xs, k, first)


@register_clusterer("kmeans")
class KMeansClusterer(_ClustererBase):
    """Spherical k-means (Lloyd) — the clusterer of the CellDec baseline:
    ``k`` random documents as the first centroids, then ``iters`` centroid
    updates of the shared tail (``iters + 1`` assignment passes, so the
    returned ``assign`` is consistent with the returned ``reps``)."""

    def __init__(self, *, iters: int = 10, chunk: int = 16384):
        super().__init__(chunk=chunk)
        self.iters = iters

    def cluster(self, x, k, generator=None, *, init_idx=None
                ) -> ClusteringResult:
        """``init_idx`` (``k`` row indices) replaces the draw from
        ``generator`` — the reference's ``permutation(key, n)[:k]``."""
        init = _draw(generator, x.shape[0], k, init_idx, x.device)
        return assign_refine(
            x, k, x[init], refine_iters=self.iters, rep_update="centroid",
            chunk=self.chunk,
        )


@register_clusterer("random")
class RandomLeaderClusterer(_ClustererBase):
    """Random-leader clustering — the PODS'07 baseline [Chierichetti et
    al.]: ``k`` random documents as leaders, every document assigned to its
    closest leader, each group's centroid as its representative. Search
    keeps the ORIGINAL leader assignment; the radius is measured from the
    centroids."""

    def cluster(self, x, k, generator=None, *, leader_idx=None
                ) -> ClusteringResult:
        """``leader_idx`` (``k`` row indices) replaces the draw from
        ``generator`` — the reference's ``permutation(key, n)[:k]``."""
        lead = x[_draw(generator, x.shape[0], k, leader_idx, x.device)]
        assign, _ = assign_to_centers(x, lead, chunk=self.chunk)
        counts = torch.bincount(assign.long(), minlength=k).to(x.dtype)
        reps = _centroids(x, assign, k, lead)
        _, sim2 = assign_to_centers(x, reps, chunk=self.chunk)
        return ClusteringResult(assign=assign, reps=reps, counts=counts,
                                max_radius=1.0 - sim2.min())


def fpf_cluster(x, k, generator=None, **opts) -> ClusteringResult:
    """Function form of ``get_clusterer("fpf")``."""
    return get_clusterer("fpf", **opts).cluster(x, k, generator)


def kmeans_cluster(x, k, generator=None, **opts) -> ClusteringResult:
    """Function form of ``get_clusterer("kmeans")``."""
    return get_clusterer("kmeans", **opts).cluster(x, k, generator)


def random_leader_cluster(x, k, generator=None, **opts) -> ClusteringResult:
    """Function form of ``get_clusterer("random")``."""
    return get_clusterer("random", **opts).cluster(x, k, generator)

"""The paper's own system as an arch config: FPF cluster-pruned retrieval
(port of :mod:`repro.configs.paper_retrieval`).

Production sizing: a 100M-document corpus (hashed multi-field tf-idf,
D = 4096 = 1024+1024+2048), doc-sharded over every mesh axis; K = 3 x 10k
clusters (leaders replicated); dynamic weighted queries reduced to plain
cosine queries at the edge (§4 theorem). Serve step = probe leaders ->
bucket gather-score (local) -> collective-light global top-k merge (2·k
words per device).

Cells:
  serve_online            batch=256 weighted queries through the pruned index
  serve_online_prefilter  the same with the two-stage JL prefilter
  serve_brute             batch=256 exhaustive (the quality baseline / GT)
  build_assign            one FPF assignment pass over the sharded corpus

Each cell's step is the program of one rank, written SPMD-style (the
reference's ``shard_map`` bodies, ``src/repro/core/distributed.py``):
:func:`serve_online_rank`, :func:`serve_brute_rank` and
:func:`build_assign_rank` on the rank's local shard, then
:func:`gather_merge`, a functional all-gather of the ``(nq, k)`` scores
and ids (the reference's 2·k-word all-gather) and ``merge_topk``. With a
group of one (``group=None``) a step runs on one card with no collective:
``chip_smoke.py`` path M runs rank 0's program at the single-pod mesh's
per-chip shape that way. The steps take plain tensors (the rank's own
shards) or DTensors placed by the cell's specs (the dry-run), whose local
shards and mesh coordinate give the rank.

bf16 as the reference: ``serve_brute`` rounds ``qw @ docs_l.T`` to bf16
before its top-k (``src/repro/core/distributed.py:115``; the ``topk_score``
kernel's ``round_bf16`` epilogue) and all-gathers them as fp32 (the
reference's compiled step sends ``f32[256, 256, 10]`` scores beside the
``s32`` ids: 8 bytes an entry); navigation's
leader scores are bf16 (the reference's bf16 einsum); the candidate scores
of ``serve_online`` and the assignment's similarities accumulate and stay
in fp32 (``preferred_element_type=float32``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.distributed import local_exclude, local_topk, merge_topk
from ..core.engine import navigate, stable_topk
from ..core.fields import FieldSpec
from ..models.transformer import matmul32
from ..runtime import trace
from ..runtime.sharding import P, axis_size, data_axes, mesh_axes
from .common import Cell, meta

__all__ = ["ARCH_ID", "RetrievalConfig", "make_config", "make_smoke_config",
           "cells", "split_probes", "serve_online_rank", "serve_brute_rank",
           "build_assign_rank", "gather_merge", "shard_rank", "pad_buckets"]

ARCH_ID = "paper-retrieval"


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    name: str = ARCH_ID
    n_docs: int = 99_999_744          # ~100M, divisible by 256 and 512 shards
    field_dims: tuple[int, ...] = (1024, 1024, 2048)
    n_clusterings: int = 3
    k_clusters: int = 10_000
    bucket_pad: int = 64              # PER-SHARD padded bucket size
                                      # (n_docs/shards/K ~ 20 rows + slack)
    k: int = 10
    probes: int = 18
    dtype = torch.bfloat16

    @property
    def spec(self) -> FieldSpec:
        return FieldSpec(names=("title", "authors", "abstract"),
                         dims=self.field_dims)

    @property
    def d(self) -> int:
        return self.spec.total_dim


def make_config() -> RetrievalConfig:
    return RetrievalConfig()


def make_smoke_config() -> RetrievalConfig:
    return RetrievalConfig(
        name=ARCH_ID + "-smoke", n_docs=2_000, field_dims=(32, 32, 64),
        n_clusterings=3, k_clusters=32, bucket_pad=16, probes=6,
    )


def split_probes(probes: int, t: int) -> tuple[int, ...]:
    """The probe budget per clustering: ``probes // t``, the first
    ``probes % t`` clusterings one more (the reference's ``probes_t``)."""
    return tuple(probes // t + (1 if i < probes % t else 0) for i in range(t))


# ------------------------------------------------------ one rank's programs
def serve_online_rank(docs_l, leaders, bkt_l, qw, *, probes_t, k,
                      offset: int, exclude=None, docs_proj_l=None,
                      qw_proj=None, shortlist: int = 64):
    """One rank of the pruned search (the body of the reference's
    ``distributed_index_search``): replicated navigation, the rank's
    candidates from its local buckets ``bkt_l (T, K, B_l)`` (sentinel
    ``n_local``), optionally the JL prefilter's shortlist, fp32 scores of
    the gathered rows, exclusion, the dedup across clusterings (a stable
    sort by local id) and the local top-k. Returns ``(scores (nq, k) f32,
    global ids (nq, k) i32)``. While profiling, counts the candidate rows
    gathered (``online.gathered``) and the live ones left after the dedup
    (``online.distinct``)."""
    nq = qw.shape[0]
    n_local = docs_l.shape[0]
    t_cl, k_clusters, b_l = bkt_l.shape
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=qw.device)
    flat = navigate(leaders, qw, probes_t)
    with trace.span("entry.online_gather"):
        bkt = bkt_l.reshape(t_cl * k_clusters, b_l)
        cand = bkt[flat.long()].reshape(nq, -1)             # (nq, m) local
        valid = cand < n_local
        neg = float("-inf")
        if docs_proj_l is not None:
            safe = torch.where(valid, cand, 0).long()
            s1 = matmul32(docs_proj_l[safe], qw_proj[:, :, None])[..., 0]
            s1 = torch.where(valid, s1, neg)
            _, keep = stable_topk(s1, min(shortlist, s1.shape[-1]))
            cand = torch.gather(cand, -1, keep)
            valid = torch.gather(valid, -1, keep)
        safe = torch.where(valid, cand, 0).long()
        s = matmul32(docs_l[safe], qw[:, :, None])[..., 0]  # (nq, m) f32
        gids = torch.where(valid, cand + offset, -1).to(torch.int32)
        s = torch.where(valid, s, neg)
        s = torch.where(gids == exclude.to(torch.int32)[:, None], neg, s)
    with trace.span("entry.online_dedup"):
        c_s, order = torch.sort(cand, dim=-1, stable=True)
        s_s = torch.gather(s, -1, order)
        g_s = torch.gather(gids, -1, order)
        dup = c_s == F.pad(c_s[:, :-1], (1, 0), value=-1)
        s_s = torch.where(dup, neg, s_s)
        if trace.profiling():
            trace.count("online.gathered", cand.numel())
            trace.count_device("online.distinct",
                               ((c_s < n_local) & ~dup).sum())
        return local_topk(s_s, g_s, k)


def serve_brute_rank(docs_l, qw, *, k, offset: int, n_valid: int,
                     exclude=None):
    """One rank of the exhaustive top-k (the body of the reference's
    ``distributed_brute_topk``): the ``topk_score`` kernel over the local
    shard with each score rounded to ``qw``'s dtype when it is bf16 (the
    reference's bf16 ``qw @ docs_l.T``), rows at or past ``n_valid``
    masked. Returns ``(scores (nq, k) f32, global ids (nq, k) i32)``."""
    from ..kernels.topk_score import topk_score

    with trace.span("entry.brute"):
        nq = qw.shape[0]
        n_local = docs_l.shape[0]
        if exclude is None:
            exclude = torch.full((nq,), -1, dtype=torch.int32,
                                 device=qw.device)
        mask = None
        if offset + n_local > n_valid:                 # sentinel pad rows
            mask = (torch.arange(n_local, device=docs_l.device) + offset
                    < n_valid)
        s, i = topk_score(qw, docs_l, k=k, mask=mask,
                          exclude=local_exclude(exclude, offset, n_local),
                          round_bf16=qw.dtype == torch.bfloat16)
        return s, torch.where(i >= 0, i + offset, -1).to(torch.int32)


def build_assign_rank(docs_l, leaders_t, *, chunk: int = 65_536):
    """Every local doc to its nearest leader of one clustering: fp32
    similarities (``preferred_element_type=float32``), first argmax on
    ties; rows in chunks of ``chunk`` so the ``(n_local, K)`` fp32 matrix
    never materialises whole. Returns ``(n_local,)`` int32."""
    out = []
    for lo in range(0, docs_l.shape[0], chunk):
        sims = matmul32(docs_l[lo:lo + chunk], leaders_t.T)
        out.append(torch.argmax(sims, dim=-1).to(torch.int32))
    return torch.cat(out)


def pad_buckets(buckets: torch.Tensor, bucket_pad: int,
                sentinel: int) -> tuple[torch.Tensor, int]:
    """Local buckets ``(..., B_l)`` (sentinel-padded, members first) cut or
    padded to ``bucket_pad`` columns -> ``(buckets, members dropped)``:
    the cell's per-shard ``bucket_pad``, as the reference's shapes assume."""
    b = buckets.shape[-1]
    if b >= bucket_pad:
        dropped = int((buckets[..., bucket_pad:] != sentinel).sum())
        return buckets[..., :bucket_pad].contiguous(), dropped
    pad = torch.full((*buckets.shape[:-1], bucket_pad - b), sentinel,
                     dtype=buckets.dtype, device=buckets.device)
    return torch.cat([buckets, pad], dim=-1), 0


def gather_merge(s, i, k: int, group=None):
    """The reference's 2·k-word merge: all-gather every rank's ``(nq, k)``
    fp32 scores and int32 ids over ``group`` (``all_gather_tensor``), then
    ``merge_topk`` (ties to the lower rank). ``group=None`` is a group of
    one."""
    with trace.span("entry.merge"):
        if group is None:
            return merge_topk(s[:, None], i[:, None], k)
        import torch.distributed._functional_collectives as funcol

        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        s_all = funcol.wait_tensor(gather(s.contiguous(), 0, group))
        i_all = funcol.wait_tensor(gather(i.contiguous(), 0, group))
        nq = s.shape[0]
        s_all = s_all.reshape(-1, nq, s.shape[1]).transpose(0, 1)
        i_all = i_all.reshape(-1, nq, i.shape[1]).transpose(0, 1)
        return merge_topk(s_all, i_all, k)


def shard_rank(x) -> tuple[int, object]:
    """``(rank, group)`` of the shard a DTensor argument's local part is:
    its mesh coordinate read major to minor over the mesh's axes (the order
    the reference's all-axes row sharding uses), and the world's group. A
    plain tensor is the only shard: ``(0, None)``."""
    if type(x).__name__ != "DTensor":
        return 0, None
    import torch.distributed as dist

    mesh = x.device_mesh
    rank = 0
    for c, n in zip(mesh.get_coordinate(), mesh_axes(mesh).values()):
        rank = rank * n + c
    return rank, dist.group.WORLD


def _local(x):
    return x.to_local() if type(x).__name__ == "DTensor" else x


# --------------------------------------------------------------- the cells
def _all_axes(mesh) -> tuple[str, ...]:
    return data_axes(mesh) + ("model",)


def _n_shards(mesh) -> int:
    return axis_size(mesh, _all_axes(mesh))


def _serve_pruned_cell(cfg: RetrievalConfig, batch: int):
    probes_t = split_probes(cfg.probes, cfg.n_clusterings)

    def build(mesh):
        all_axes = _all_axes(mesh)
        n_shards = _n_shards(mesh)
        t, kc, bp = cfg.n_clusterings, cfg.k_clusters, cfg.bucket_pad

        def step(docs, leaders, buckets_local, qw):
            rank, group = shard_rank(docs)
            docs_l = _local(docs)
            s, i = serve_online_rank(
                docs_l, _local(leaders), _local(buckets_local)[0],
                _local(qw), probes_t=probes_t, k=cfg.k,
                offset=rank * docs_l.shape[0])
            return gather_merge(s, i, cfg.k, group)

        args = (meta((cfg.n_docs, cfg.d), cfg.dtype),
                meta((t, kc, cfg.d), cfg.dtype),
                meta((n_shards, t, kc, bp), torch.int32),
                meta((batch, cfg.d), cfg.dtype))
        in_shard = (P(all_axes, None), P(None, None, None),
                    P(all_axes, None, None, None), P(None, None))
        return step, args, in_shard, (P(None, None), P(None, None))

    return Cell(
        arch=ARCH_ID, shape="serve_online", kind="retrieval", build=build,
        note="paper's pruned search, multi-pod",
        model_flops=2.0 * batch * cfg.d * (
            cfg.n_clusterings * cfg.k_clusters
            + cfg.probes * cfg.bucket_pad * 512),
    )


def _serve_pruned_prefilter_cell(cfg: RetrievalConfig, batch: int,
                                 proj_dim: int = 256, shortlist: int = 64):
    """Two-stage JL-projected candidate scoring."""
    probes_t = split_probes(cfg.probes, cfg.n_clusterings)

    def build(mesh):
        all_axes = _all_axes(mesh)
        n_shards = _n_shards(mesh)
        t, kc, bp = cfg.n_clusterings, cfg.k_clusters, cfg.bucket_pad

        def step(docs, docs_proj, leaders, buckets_local, qw, qw_proj):
            rank, group = shard_rank(docs)
            docs_l = _local(docs)
            s, i = serve_online_rank(
                docs_l, _local(leaders), _local(buckets_local)[0],
                _local(qw), probes_t=probes_t, k=cfg.k,
                offset=rank * docs_l.shape[0], docs_proj_l=_local(docs_proj),
                qw_proj=_local(qw_proj), shortlist=shortlist)
            return gather_merge(s, i, cfg.k, group)

        args = (meta((cfg.n_docs, cfg.d), cfg.dtype),
                meta((cfg.n_docs, proj_dim), cfg.dtype),
                meta((t, kc, cfg.d), cfg.dtype),
                meta((n_shards, t, kc, bp), torch.int32),
                meta((batch, cfg.d), cfg.dtype),
                meta((batch, proj_dim), cfg.dtype))
        in_shard = (P(all_axes, None), P(all_axes, None), P(None, None, None),
                    P(all_axes, None, None, None), P(None, None),
                    P(None, None))
        return step, args, in_shard, (P(None, None), P(None, None))

    return Cell(
        arch=ARCH_ID, shape="serve_online_prefilter", kind="retrieval",
        build=build, note="two-stage JL prefilter (beyond-paper, §Perf)",
        model_flops=2.0 * batch * (
            cfg.n_clusterings * cfg.k_clusters * cfg.d
            + cfg.probes * cfg.bucket_pad * 512 * proj_dim
            + shortlist * 512 * cfg.d),
    )


def _serve_brute_cell(cfg: RetrievalConfig, batch: int):
    def build(mesh):
        all_axes = _all_axes(mesh)

        def step(docs, qw):
            rank, group = shard_rank(docs)
            docs_l = _local(docs)
            s, i = serve_brute_rank(docs_l, _local(qw), k=cfg.k,
                                    offset=rank * docs_l.shape[0],
                                    n_valid=docs.shape[0])
            return gather_merge(s, i, cfg.k, group)

        args = (meta((cfg.n_docs, cfg.d), cfg.dtype),
                meta((batch, cfg.d), cfg.dtype))
        in_shard = (P(all_axes, None), P(None, None))
        return step, args, in_shard, (P(None, None), P(None, None))

    return Cell(arch=ARCH_ID, shape="serve_brute", kind="retrieval",
                build=build, note="exhaustive baseline (ground truth)",
                model_flops=2.0 * batch * cfg.n_docs * cfg.d)


def _build_assign_cell(cfg: RetrievalConfig):
    """One assignment pass: every doc to its nearest of K leaders (the
    dominating preprocessing cost after FPF-on-sample)."""

    def build(mesh):
        all_axes = _all_axes(mesh)

        def step(docs, leaders):
            return build_assign_rank(_local(docs), _local(leaders)[0])

        args = (meta((cfg.n_docs, cfg.d), cfg.dtype),
                meta((cfg.n_clusterings, cfg.k_clusters, cfg.d), cfg.dtype))
        in_shard = (P(all_axes, None), P(None, None, None))
        return step, args, in_shard, P(all_axes)

    return Cell(arch=ARCH_ID, shape="build_assign", kind="build", build=build,
                model_flops=2.0 * cfg.n_docs * cfg.k_clusters * cfg.d)


def cells(cfg: RetrievalConfig | None = None):
    cfg = cfg or make_config()
    return [
        _serve_pruned_cell(cfg, batch=256),
        _serve_pruned_prefilter_cell(cfg, batch=256),
        _serve_brute_cell(cfg, batch=256),
        _build_assign_cell(cfg),
    ]

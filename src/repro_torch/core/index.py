"""Multi-clustering cluster-prune index (port of :mod:`repro.core.index`).

Build: ``T`` (default 3) independent clusterings of the weight-free
concatenated corpus by a registered clusterer (``method="auto"`` picks
``fpf_fused`` on the card). The index owns the padded ``(T, K, B)``
bucket-id tensor (sentinel ``n``), the per-clustering assignments, and the
bucket-major ``(T, K, B, D)`` pack the fused backend scores from (fp32,
bf16, or int8 with per-bucket scales), materialised once, lazily.

The saved ``.npz`` is the bridge between the two packages: :meth:`load`
reads the reference's archives (through :meth:`from_numpy`) and
:meth:`save` writes archives ``repro.core.ClusterPruneIndex.load`` accepts.

An index may carry a fitted :class:`~repro_torch.core.calibrate.ProbeLadder`
(``ladder``: ``build(calibrate=...)``, or lazily through a ``Retriever``);
it is saved as the reference's JSON member, so a calibrated archive crosses
between the packages both ways.

The index is not frozen at build time: :meth:`add_documents` assigns new
documents with the build tail's ``assign_to_centers_multi`` and scatters
them into free padded bucket slots on the host (growing ``B`` only when a
bucket overflows); :meth:`remove_documents` tombstones documents out of
every bucket. Each mutation bumps ``version``, adds to ``n_mutations`` and
drops the bucket-major pack and the cached engines, so the next fused
search re-packs once.

Search execution lives in :mod:`repro_torch.core.engine`;
:meth:`ClusterPruneIndex.search` is the reference's thin delegation to it.
The ``sharded`` backend scores from :meth:`ensure_local_bucket_major`, a
shard-local pack cached per shard count and dropped with the rest on a
mutation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import zipfile
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..runtime.trace import span
from .calibrate import ProbeLadder
from .cluster import assign_to_centers_multi, get_clusterer
from .fields import FieldSpec, normalize_fields

__all__ = [
    "ClusterPruneIndex", "CorruptIndexError", "pack_buckets",
    "pack_buckets_major", "validate_pack_dtype", "SUPPORTED_PACK_DTYPES",
    "LADDER_DRIFT_THRESHOLD",
]


class CorruptIndexError(Exception):
    """A saved index failed to load: truncated, mismatched or unreadable.
    The message names the failing file or archive member."""


SUPPORTED_PACK_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}

# Fraction of the corpus that may churn (adds + removes) before a calibrated
# ProbeLadder is reported stale (the reference's threshold).
LADDER_DRIFT_THRESHOLD = 0.1

# Materialise the bucket-major pack at build (on the card, where the fused
# backend serves) when it costs less than this; otherwise on first search.
_PACK_MAJOR_AUTO_BYTES = 256 * 2**20


def validate_pack_dtype(pack_dtype) -> str | None:
    """Canonical name of a ``pack_dtype`` spec (None keeps fp32), or
    ``ValueError`` listing the supported precisions."""
    if pack_dtype is None:
        return None
    if isinstance(pack_dtype, torch.dtype):
        name = str(pack_dtype).replace("torch.", "")
    else:
        try:
            name = np.dtype(pack_dtype).name
        except TypeError as e:
            name = str(pack_dtype)
            if name not in SUPPORTED_PACK_DTYPES:
                raise ValueError(
                    f"unsupported pack_dtype {pack_dtype!r}: not a dtype "
                    f"(supported: {', '.join(SUPPORTED_PACK_DTYPES)})"
                ) from e
    if name not in SUPPORTED_PACK_DTYPES:
        raise ValueError(
            f"unsupported pack_dtype {name!r} "
            f"(supported: {', '.join(SUPPORTED_PACK_DTYPES)})"
        )
    return name


def pack_buckets(
    assign: np.ndarray, k: int, n: int, bucket_pad: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack an assignment vector into a padded ``(K, B)`` bucket-id matrix
    (host numpy, as the reference). Padding is the sentinel ``n``; ``B`` is
    the largest bucket rounded up to a multiple of 8; entries with
    ``assign < 0`` are skipped."""
    assign = np.asarray(assign)
    valid_idx = np.flatnonzero(assign >= 0)
    a = assign[valid_idx]
    counts = np.bincount(a, minlength=k).astype(np.int32)
    b = (int(counts.max()) if counts.size else 1) if bucket_pad is None \
        else bucket_pad
    b = max(8, -(-b // 8) * 8)
    ids = np.full((k, b), n, dtype=np.int32)
    order = valid_idx[np.argsort(a, kind="stable")]
    sorted_assign = assign[order]
    start = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    pos = np.arange(len(order)) - start[sorted_assign]
    ids[sorted_assign, pos] = order
    return ids, counts


def pack_buckets_major(
    docs: torch.Tensor, buckets: torch.Tensor, n: int, dtype=None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(n, D)`` corpus + ``(T, K, B)`` ids (sentinel ``n``) -> the
    ``(T, K, B, D)`` bucket-major pack in ``dtype`` storage, plus ``(T, K)``
    int8 scales (None for other dtypes)."""
    from ..kernels.bucket_score.ops import pack_bucket_major

    name = validate_pack_dtype(dtype)
    data, _, scales = pack_bucket_major(
        docs, torch.where(buckets < n, buckets, -1),
        dtype=None if name is None else _TORCH_DTYPES[name],
    )
    return data, scales


@dataclasses.dataclass
class ClusterPruneIndex:
    """The paper's index: T independent clusterings over a weight-free
    corpus, on one device."""

    spec: FieldSpec
    docs: torch.Tensor       # (n, D) per-field unit-normalised corpus
    leaders: torch.Tensor    # (T, K, D)
    buckets: torch.Tensor    # (T, K, B) int32, sentinel = n
    counts: torch.Tensor     # (T, K) int32 live members per bucket
    method: str = "fpf"
    assign: np.ndarray | None = None        # (T, n) cluster of each doc (-1 = removed)
    bucket_data: torch.Tensor | None = None   # (T, K, B, D) bucket-major pack
    bucket_scales: torch.Tensor | None = None  # (T, K) fp32 int8 scales
    pack_dtype: str | None = None           # pack storage dtype (None = fp32)
    ladder: ProbeLadder | None = None       # fitted recall -> probes map
    removed: np.ndarray | None = None       # (n,) bool tombstones (or None)
    version: int = 0                        # bumped on every mutation
    n_mutations: int = 0                    # docs churned since calibration

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        docs,
        spec: FieldSpec,
        k_clusters: int,
        *,
        n_clusterings: int = 3,
        method: str = "auto",
        generator: torch.Generator | None = None,
        pack_major: bool | None = None,
        pack_dtype=None,
        calibrate: bool | Mapping = False,
        device=None,
        draws: Sequence[Mapping] | None = None,
        **clusterer_kwargs,
    ) -> "ClusterPruneIndex":
        """Cluster T ways on ``device`` (the card unless ``"cpu"``), pack
        buckets, and materialise the bucket-major pack when the fused
        backend will serve it and it is small (``pack_major=None``).

        ``generator`` (a CPU ``torch.Generator``, seed 0 when None) draws
        every clustering's sample and first center in turn; the reference
        splits a JAX key instead, so the two packages build different
        indexes from the same seed.

        ``calibrate``: True fits the per-index recall -> probes
        :class:`~repro_torch.core.calibrate.ProbeLadder` right after the
        build; a Mapping (even empty) does too, with its entries as
        :func:`~repro_torch.core.calibrate.calibrate_index` options.

        ``draws`` (one Mapping per clustering) pass each clustering's random
        draws to its ``cluster`` call in place of the generator's
        (``sample_idx``/``first`` for FPF, ``init_idx`` for k-means,
        ``leader_idx`` for random leaders): how a test replays the
        reference's draws.
        """
        dev = resolve_device(device)
        docs = torch.as_tensor(np.asarray(docs) if not isinstance(
            docs, torch.Tensor) else docs).to(dev, torch.float32).contiguous()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n = docs.shape[0]
        clusterer = get_clusterer(method, device=dev, **clusterer_kwargs)
        reps_l, ids_l, counts_l, assign_l = [], [], [], []
        if draws is not None and len(draws) != n_clusterings:
            raise ValueError(f"draws holds {len(draws)} entries for "
                             f"{n_clusterings} clusterings")
        for t in range(n_clusterings):
            res = clusterer.cluster(docs, k_clusters, generator,
                                    **(dict(draws[t]) if draws else {}))
            reps_l.append(res.reps)
            with span("build.buckets"):
                assign = res.assign.cpu().numpy()
                assign_l.append(assign)
                ids, counts = pack_buckets(assign, k_clusters, n)
                ids_l.append(ids)
                counts_l.append(counts)
        with span("build.buckets"):
            b = max(ids.shape[1] for ids in ids_l)
            ids_l = [
                np.pad(ids, ((0, 0), (0, b - ids.shape[1])),
                       constant_values=n)
                for ids in ids_l
            ]
            pack_dtype = validate_pack_dtype(pack_dtype)
            index = cls(
                spec=spec,
                docs=docs,
                leaders=torch.stack(reps_l),
                buckets=torch.as_tensor(np.stack(ids_l), device=dev),
                counts=torch.as_tensor(np.stack(counts_l), device=dev),
                method=clusterer.name,
                assign=np.stack(assign_l).astype(np.int64),
                pack_dtype=pack_dtype,
            )
        if pack_major is None:
            itemsize = _TORCH_DTYPES[pack_dtype or "float32"].itemsize
            pack_major = (
                dev.type == "cuda"
                and index.buckets.numel() * docs.shape[1] * itemsize
                <= _PACK_MAJOR_AUTO_BYTES
            )
        if pack_major:
            with span("build.pack"):
                index.bucket_data, index.bucket_scales = pack_buckets_major(
                    docs, index.buckets, n, dtype=pack_dtype
                )
        if calibrate or isinstance(calibrate, Mapping):
            from .calibrate import calibrate_index

            calibrate_index(
                index,
                **(dict(calibrate) if isinstance(calibrate, Mapping) else {}),
            )
        return index

    @classmethod
    def from_numpy(cls, arrays, *, device=None) -> "ClusterPruneIndex":
        """An index from the reference's state as numpy arrays: ``docs``,
        ``leaders``, ``buckets``, ``counts``, ``assign``, ``names``,
        ``dims``, ``method``, ``pack_dtype``, ``bucket_scales`` (and
        optionally ``removed``, ``n_mutations``, and ``ladder`` as a
        :class:`ProbeLadder` or its JSON) — the members of a saved archive,
        empty arrays and strings standing for None."""
        dev = resolve_device(device)
        a = dict(arrays)
        ladder = a.get("ladder")
        if ladder is not None and not isinstance(ladder, ProbeLadder):
            ladder = (ProbeLadder.from_dict(json.loads(str(ladder)))
                      if str(ladder) else None)
        assign = np.asarray(a["assign"])
        removed = np.asarray(a.get("removed", np.zeros(0, bool)))
        scales = np.asarray(a.get("bucket_scales", np.zeros((0, 0))))
        pack_dtype = validate_pack_dtype(str(a.get("pack_dtype", "")) or None)
        return cls(
            spec=FieldSpec(
                names=tuple(str(x) for x in np.asarray(a["names"])),
                dims=tuple(int(x) for x in np.asarray(a["dims"])),
            ),
            docs=torch.as_tensor(np.asarray(a["docs"], np.float32), device=dev),
            leaders=torch.as_tensor(np.asarray(a["leaders"], np.float32),
                                    device=dev),
            buckets=torch.as_tensor(np.asarray(a["buckets"], np.int32),
                                    device=dev),
            counts=torch.as_tensor(np.asarray(a["counts"], np.int32),
                                   device=dev),
            method=str(a.get("method", "fpf")),
            assign=assign.astype(np.int64) if assign.size else None,
            removed=removed.astype(bool) if removed.size else None,
            n_mutations=int(a.get("n_mutations", 0)),
            ladder=ladder,
            pack_dtype=pack_dtype,
            bucket_scales=(
                torch.as_tensor(scales.astype(np.float32), device=dev)
                if scales.size else None
            ),
        )

    # ------------------------------------------------------------- structure
    @property
    def n_docs(self) -> int:
        """Corpus rows (tombstoned documents included — ids are stable)."""
        return self.docs.shape[0]

    @property
    def n_live(self) -> int:
        """Documents reachable through the buckets."""
        gone = 0 if self.removed is None else int(self.removed.sum())
        return self.n_docs - gone

    @property
    def ladder_stale(self) -> bool:
        """True when the calibrated ladder predates too much corpus churn:
        adds + removes beyond :data:`LADDER_DRIFT_THRESHOLD` of the live
        corpus (``calibrate_index`` resets the counter when it refits)."""
        if self.ladder is None:
            return False
        return self.n_mutations > LADDER_DRIFT_THRESHOLD * max(1, self.n_live)

    def assignments(self) -> np.ndarray:
        """(T, n) cluster per doc, -1 for removed docs (derived from the
        buckets when the index carries no ``assign``)."""
        if self.assign is not None:
            return self.assign
        t, k_clusters, _ = self.buckets.shape
        bk = self.buckets.cpu().numpy()
        out = np.full((t, self.n_docs), -1, np.int64)
        for ti in range(t):
            for c in range(k_clusters):
                row = bk[ti, c]
                out[ti, row[row < self.n_docs]] = c
        return out

    # ---------------------------------------------------------- maintenance
    def drop_packs(self) -> None:
        """Free the bucket-major packs (whole and per shard) and the cached
        engines; the next fused or sharded search re-packs. Answers do not
        change, so ``version`` stays."""
        self.bucket_data = None
        self.bucket_scales = None
        self.__dict__.pop("_bucket_major_flat", None)
        self.__dict__.pop("_local_bucket_major", None)
        self.__dict__.pop("_engines", None)

    def _invalidate(self) -> None:
        """After a mutation: drop the packs and engines
        (:meth:`drop_packs`) and bump ``version`` (the key of every
        retriever-level cache)."""
        self.drop_packs()
        self.version += 1

    def add_documents(self, new_docs, *, chunk: int = 16384) -> np.ndarray:
        """Ingest documents without a rebuild; returns their new doc ids.

        The batch is per-field normalised, assigned under all T clusterings
        by one ``assign_to_centers_multi`` on the index's device, and
        scattered on the host into free padded slots: each (clustering,
        cluster) group of new docs, in id order, takes its row's free
        columns in ascending order (two stable sorts, as the reference).
        ``B`` grows to the next multiple of 8 only when a bucket overflows;
        every padded slot holds the new sentinel ``n``. Leaders do not move.
        """
        dev = self.docs.device
        new_docs = torch.atleast_2d(torch.as_tensor(
            np.asarray(new_docs) if not isinstance(new_docs, torch.Tensor)
            else new_docs).to(dev, torch.float32))
        if new_docs.shape[-1] != self.spec.total_dim:
            raise ValueError(
                f"new docs have dim {new_docs.shape[-1]}, corpus concat dim "
                f"is {self.spec.total_dim}"
            )
        m = int(new_docs.shape[0])
        if m == 0:
            return np.empty((0,), np.int64)
        new_docs = normalize_fields(new_docs, self.spec).contiguous()
        n_old = self.n_docs
        n_new = n_old + m
        t, k_clusters, b = (int(x) for x in self.buckets.shape)

        new_assign = assign_to_centers_multi(
            new_docs, self.leaders, chunk=chunk)[0].cpu().numpy().astype(
                np.int64)                                  # (T, m)
        all_assign = self.assignments()                    # (T, n_old)
        counts = self.counts.cpu().numpy().copy()
        add_counts = np.zeros_like(counts)
        np.add.at(add_counts,
                  (np.repeat(np.arange(t), m), new_assign.reshape(-1)), 1)

        need = int((counts + add_counts).max())
        new_b = b if need <= b else max(8, -(-need // 8) * 8)
        bk = self.buckets.cpu().numpy()
        out = np.full((t, k_clusters, new_b), n_new, np.int32)
        live = bk < n_old
        out[:, :, :b][live] = bk[live]

        ids_new = np.arange(n_old, n_new, dtype=np.int64)
        rows = out.reshape(t * k_clusters, new_b)
        flat_c = (new_assign + np.arange(t)[:, None] * k_clusters
                  ).reshape(-1)                             # (T·m,) row keys
        order = np.argsort(flat_c, kind="stable")
        sorted_c = flat_c[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sorted_c)) + 1]
        group_len = np.diff(np.r_[starts, sorted_c.size])
        rank = np.arange(sorted_c.size) - np.repeat(starts, group_len)
        free_cols = np.argsort(rows != n_new, axis=1, kind="stable")
        rows[sorted_c, free_cols[sorted_c, rank]] = np.tile(ids_new, t)[order]
        counts += add_counts

        self.docs = torch.cat([self.docs, new_docs])
        self.buckets = torch.as_tensor(out, device=dev)
        self.counts = torch.as_tensor(counts, device=dev)
        self.assign = np.concatenate([all_assign, new_assign], axis=1)
        if self.removed is not None:
            self.removed = np.concatenate([self.removed, np.zeros((m,), bool)])
        self.n_mutations += m
        self._invalidate()
        return ids_new

    def remove_documents(self, doc_ids) -> int:
        """Tombstone documents out of every bucket; returns how many were
        newly removed (already-removed ids are ignored, ids outside
        ``[0, n)`` raise). Corpus rows stay in place (ids are stable
        handles); the freed slots take the sentinel ``n`` and become free
        capacity for later adds."""
        ids = np.unique(np.asarray(doc_ids, np.int64).reshape(-1))
        if ids.size == 0:
            return 0
        n = self.n_docs
        if ids[0] < 0 or ids[-1] >= n:
            raise ValueError(
                f"doc ids must be in [0, {n}), got range "
                f"[{ids[0]}, {ids[-1]}]"
            )
        removed = (self.removed.copy() if self.removed is not None
                   else np.zeros((n,), bool))
        fresh = ids[~removed[ids]]
        if fresh.size == 0:
            return 0
        dev = self.docs.device
        all_assign = self.assignments().copy()            # (T, n)
        bk = self.buckets.cpu().numpy().copy()
        bk[np.isin(bk, fresh)] = n
        counts = self.counts.cpu().numpy().copy()
        for ti in range(all_assign.shape[0]):
            a = all_assign[ti, fresh]
            np.subtract.at(counts[ti], a[a >= 0], 1)
        all_assign[:, fresh] = -1
        removed[fresh] = True

        self.buckets = torch.as_tensor(bk, device=dev)
        self.counts = torch.as_tensor(counts, device=dev)
        self.assign = all_assign
        self.removed = removed
        self.n_mutations += int(fresh.size)
        self._invalidate()
        return int(fresh.size)

    def build_lock(self) -> threading.RLock:
        """The lock under which the bucket-major pack and the cached
        engines are built: serving replicas search one index from several
        threads, and each would otherwise build its own (``dict.setdefault``
        is atomic, so two first callers get the same lock). Mutations do
        not take it: they are not guarded while a server runs, as in the
        reference."""
        return self.__dict__.setdefault("_build_lock", threading.RLock())

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_build_lock", None)      # a copy builds under its own
        return state

    def ensure_bucket_major(self):
        """Bucket-major view for the fused backend: ``((T·K, B, D) data,
        (T·K, B) int32 ids with -1 padding, (T·K,) fp32 scales | None)``,
        packed in ``pack_dtype`` on first use and cached. The first use
        packs once, under :meth:`build_lock`; the building stream is
        synchronised before the pack is published, so a replica reading it
        on another CUDA stream never reads a pack still being written."""
        cached = self.__dict__.get("_bucket_major_flat")
        if cached is not None:
            return cached
        with self.build_lock():
            cached = self.__dict__.get("_bucket_major_flat")
            if cached is not None:
                return cached
            self.pack_dtype = validate_pack_dtype(self.pack_dtype)
            if self.bucket_data is None:
                self.bucket_data, self.bucket_scales = pack_buckets_major(
                    self.docs, self.buckets, self.n_docs,
                    dtype=self.pack_dtype
                )
            t, k_clusters, b, d = self.bucket_data.shape
            ids = torch.where(self.buckets < self.n_docs, self.buckets, -1)
            flat = (
                self.bucket_data.reshape(t * k_clusters, b, d),
                ids.reshape(t * k_clusters, b).to(torch.int32).contiguous(),
                (None if self.bucket_scales is None
                 else self.bucket_scales.reshape(t * k_clusters)),
            )
            if self.docs.device.type == "cuda":
                torch.cuda.current_stream(self.docs.device).synchronize()
            self._bucket_major_flat = flat
        return flat

    def ensure_local_bucket_major(self, n_shards: int):
        """Shard-local bucket-major pack for the sharded backend: ``((S,
        T·K, B_l, D) data, (S, T·K, B_l) int32 LOCAL ids with -1 padding,
        (S, T·K) fp32 scales | None, n_local rows per shard)``
        (:func:`~repro_torch.core.distributed.pack_local_bucket_major`, in
        ``pack_dtype``; int8 quantises per ``(shard, bucket)``), on the
        index's device. Cached per shard count and dropped by
        :meth:`_invalidate`; built once under :meth:`build_lock`, and the
        building stream is synchronised before the pack is published, as
        :meth:`ensure_bucket_major` does."""
        from .distributed import pack_local_bucket_major

        n_shards = int(n_shards)
        hit = self.__dict__.get("_local_bucket_major", {}).get(n_shards)
        if hit is not None:
            return hit
        with self.build_lock():
            cache = self.__dict__.setdefault("_local_bucket_major", {})
            if n_shards not in cache:
                self.pack_dtype = validate_pack_dtype(self.pack_dtype)
                packed = pack_local_bucket_major(
                    self.docs, self.assignments(),
                    int(self.buckets.shape[1]), n_shards,
                    dtype=self.pack_dtype)
                if self.docs.device.type == "cuda":
                    torch.cuda.current_stream(self.docs.device).synchronize()
                cache[n_shards] = packed
            return cache[n_shards]

    # ------------------------------------------------------------ persistence
    def save(self, path) -> None:
        """Write the index to one ``.npz`` that the reference's ``load``
        accepts (the bucket-major pack is not stored; the int8 scales and
        the calibrated ladder, as the reference's JSON, are).
        Crash-safe: a temp file in the target directory, then an atomic
        ``os.replace``."""
        final = os.fspath(path)
        if not final.endswith(".npz"):
            final += ".npz"
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(final) or ".",
            prefix=os.path.basename(final) + ".tmp.",
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **self._archive())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _archive(self) -> dict:
        return dict(
            docs=self.docs.cpu().numpy(),
            leaders=self.leaders.cpu().numpy(),
            buckets=self.buckets.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
            assign=(self.assign if self.assign is not None
                    else np.zeros((0, 0), np.int64)),
            method=np.str_(self.method),
            names=np.asarray(self.spec.names),
            dims=np.asarray(self.spec.dims, np.int64),
            ladder=np.str_(
                "" if self.ladder is None
                else json.dumps(self.ladder.to_dict())
            ),
            removed=(self.removed if self.removed is not None
                     else np.zeros((0,), bool)),
            n_mutations=np.int64(self.n_mutations),
            pack_dtype=np.str_(self.pack_dtype or ""),
            bucket_scales=(
                self.bucket_scales.cpu().numpy()
                if self.bucket_scales is not None
                else np.zeros((0, 0), np.float32)
            ),
        )

    @classmethod
    def load(cls, path, *, device=None) -> "ClusterPruneIndex":
        """Read a saved archive (the reference's or the port's) onto
        ``device`` through :meth:`from_numpy`, its calibrated ladder
        included. Raises :class:`CorruptIndexError` naming the failing file
        or member (invalid ladder JSON included)."""
        fname = os.fspath(path)
        try:
            z = np.load(path, allow_pickle=False)
        except FileNotFoundError:
            raise
        except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
            raise CorruptIndexError(
                f"saved index {fname!r} is not a readable .npz archive "
                f"(truncated save or not an index file): {e}"
            ) from e

        def member(key, required=True, default=None):
            if key not in z.files:
                if required:
                    raise CorruptIndexError(
                        f"saved index {fname!r} is missing required "
                        f"member {key!r} (have {sorted(z.files)})"
                    )
                return default
            try:
                return z[key]
            except Exception as e:
                raise CorruptIndexError(
                    f"member {key!r} of saved index {fname!r} failed to "
                    f"decompress (truncated or corrupt archive): {e}"
                ) from e

        with z:
            ladder_json = str(member("ladder"))
            try:
                ladder = (ProbeLadder.from_dict(json.loads(ladder_json))
                          if ladder_json else None)
            except (ValueError, KeyError, TypeError) as e:
                raise CorruptIndexError(
                    f"member 'ladder' of saved index {fname!r} holds "
                    f"invalid calibration JSON: {e}"
                ) from e
            arrays = {
                key: member(key)
                for key in ("docs", "leaders", "buckets", "counts", "assign",
                            "method", "names", "dims")
            }
            for key, default in (("removed", np.zeros(0, bool)),
                                 ("n_mutations", 0),
                                 ("pack_dtype", ""),
                                 ("bucket_scales", np.zeros((0, 0)))):
                arrays[key] = member(key, required=False, default=default)
        arrays["ladder"] = ladder
        docs, dims = arrays["docs"], arrays["dims"]
        if docs.ndim != 2:
            raise CorruptIndexError(
                f"member 'docs' of saved index {fname!r} has shape "
                f"{docs.shape}, expected a 2-D (n, D) corpus"
            )
        total = int(np.sum(np.asarray(dims, np.int64)))
        if total != int(docs.shape[1]):
            raise CorruptIndexError(
                f"saved index {fname!r} is internally inconsistent: field "
                f"dims {[int(d) for d in dims]} sum to {total} but 'docs' "
                f"has dim {int(docs.shape[1])} (mismatched members — partial "
                f"overwrite?)"
            )
        return cls.from_numpy(arrays, device=device)

    # ----------------------------------------------------------------- search
    def search_weighted(self, q, w, *, probes: int, k: int, exclude=None,
                        backend: str = "reference"):
        """Search with per-field queries ``q (nq, D)`` and weights
        ``w (nq, s)`` (a 1-D query keeps the squeezed result shape)."""
        from .weights import weighted_query

        dev = self.docs.device
        qw = weighted_query(torch.as_tensor(q, device=dev),
                            torch.as_tensor(w, device=dev), self.spec)
        return self.search(qw, probes=probes, k=k, exclude=exclude,
                           backend=backend)

    def search(self, qw, *, probes: int, k: int, exclude=None,
               qchunk: int | None = None, nav_query=None,
               backend: str = "reference"):
        """Cluster-pruned top-k for pre-weighted queries ``qw (nq, D)``:
        ``(scores (nq, k), ids (nq, k), n_scored (nq,))``.

        The reference's thin delegation to :mod:`repro_torch.core.engine`
        (``backend``: ``"reference"``, ``"fused"``, ``"sharded"`` or
        ``"auto"``).
        ``nav_query`` navigates the leaders in place of ``qw`` (CellDec
        navigates with its region's composite query). ``qchunk`` is
        honoured only by the ``reference`` backend; with any other it
        raises instead of being dropped.
        """
        from .engine import get_engine, pick_backend

        name = pick_backend(self) if backend in (None, "auto") else backend
        if qchunk is not None and name != "reference":
            raise ValueError(
                f"qchunk={qchunk} is only honoured by the 'reference' "
                f"backend, but backend={name!r} would silently ignore it; "
                "drop qchunk or use backend='reference'"
            )
        opts = {"qchunk": qchunk} if qchunk is not None else {}
        return get_engine(self, name, **opts).search(
            qw, probes=probes, k=k, exclude=exclude, nav_query=nav_query
        )

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

Not ported yet: ``add_documents`` / ``remove_documents`` /
``ensure_local_bucket_major``, and the calibrated ``ProbeLadder`` (an
archive that carries one raises ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from ..kernels.common import resolve_device
from .cluster import get_clusterer
from .fields import FieldSpec

__all__ = [
    "ClusterPruneIndex", "CorruptIndexError", "pack_buckets",
    "pack_buckets_major", "validate_pack_dtype", "SUPPORTED_PACK_DTYPES",
]


class CorruptIndexError(Exception):
    """A saved index failed to load: truncated, mismatched or unreadable.
    The message names the failing file or archive member."""


SUPPORTED_PACK_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}

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
    removed: np.ndarray | None = None       # (n,) bool tombstones (or None)
    version: int = 0                        # bumped on every mutation
    n_mutations: int = 0

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
        calibrate: bool | dict = False,
        device=None,
        **clusterer_kwargs,
    ) -> "ClusterPruneIndex":
        """Cluster T ways on ``device`` (the card unless ``"cpu"``), pack
        buckets, and materialise the bucket-major pack when the fused
        backend will serve it and it is small (``pack_major=None``).

        ``generator`` (a CPU ``torch.Generator``, seed 0 when None) draws
        every clustering's sample and first center in turn; the reference
        splits a JAX key instead, so the two packages build different
        indexes from the same seed.
        """
        if calibrate or isinstance(calibrate, dict):
            raise NotImplementedError(
                "planner calibration (ProbeLadder) is not ported yet; build "
                "with calibrate=False"
            )
        dev = resolve_device(device)
        docs = torch.as_tensor(np.asarray(docs) if not isinstance(
            docs, torch.Tensor) else docs).to(dev, torch.float32).contiguous()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n = docs.shape[0]
        clusterer = get_clusterer(method, device=dev, **clusterer_kwargs)
        reps_l, ids_l, counts_l, assign_l = [], [], [], []
        for _ in range(n_clusterings):
            res = clusterer.cluster(docs, k_clusters, generator)
            reps_l.append(res.reps)
            assign = res.assign.cpu().numpy()
            assign_l.append(assign)
            ids, counts = pack_buckets(assign, k_clusters, n)
            ids_l.append(ids)
            counts_l.append(counts)
        b = max(ids.shape[1] for ids in ids_l)
        ids_l = [
            np.pad(ids, ((0, 0), (0, b - ids.shape[1])), constant_values=n)
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
            index.bucket_data, index.bucket_scales = pack_buckets_major(
                docs, index.buckets, n, dtype=pack_dtype
            )
        return index

    @classmethod
    def from_numpy(cls, arrays, *, device=None) -> "ClusterPruneIndex":
        """An index from the reference's state as numpy arrays: ``docs``,
        ``leaders``, ``buckets``, ``counts``, ``assign``, ``names``,
        ``dims``, ``method``, ``pack_dtype``, ``bucket_scales`` (and
        optionally ``removed``, ``n_mutations``) — the members of a saved
        archive, empty arrays standing for None."""
        dev = resolve_device(device)
        a = dict(arrays)
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

    def ensure_bucket_major(self):
        """Bucket-major view for the fused backend: ``((T·K, B, D) data,
        (T·K, B) int32 ids with -1 padding, (T·K,) fp32 scales | None)``,
        packed in ``pack_dtype`` on first use and cached."""
        cached = self.__dict__.get("_bucket_major_flat")
        if cached is not None:
            return cached
        self.pack_dtype = validate_pack_dtype(self.pack_dtype)
        if self.bucket_data is None:
            self.bucket_data, self.bucket_scales = pack_buckets_major(
                self.docs, self.buckets, self.n_docs, dtype=self.pack_dtype
            )
        t, k_clusters, b, d = self.bucket_data.shape
        ids = torch.where(self.buckets < self.n_docs, self.buckets, -1)
        self._bucket_major_flat = (
            self.bucket_data.reshape(t * k_clusters, b, d),
            ids.reshape(t * k_clusters, b).to(torch.int32).contiguous(),
            (None if self.bucket_scales is None
             else self.bucket_scales.reshape(t * k_clusters)),
        )
        return self._bucket_major_flat

    # ------------------------------------------------------------ persistence
    def save(self, path) -> None:
        """Write the index to one ``.npz`` that the reference's ``load``
        accepts (the bucket-major pack is not stored; the int8 scales are).
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
            ladder=np.str_(""),
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
        ``device`` through :meth:`from_numpy`. Raises
        :class:`CorruptIndexError` naming the failing file or member, and
        ``NotImplementedError`` for an archive that carries a calibrated
        ladder (the calibration slice is not ported yet)."""
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
            if ladder_json:
                try:
                    json.loads(ladder_json)
                except ValueError as e:
                    raise CorruptIndexError(
                        f"member 'ladder' of saved index {fname!r} holds "
                        f"invalid calibration JSON: {e}"
                    ) from e
                raise NotImplementedError(
                    f"saved index {fname!r} carries a calibrated ProbeLadder; "
                    "the calibration slice (core/calibrate.py) is not ported "
                    "yet — save the index without calibration"
                )
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

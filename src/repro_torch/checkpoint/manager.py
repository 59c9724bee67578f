"""Atomic, manifest-hashed checkpoints of a tree of tensors (port of
:mod:`repro.checkpoint.manager`).

The checkpoint directory is the bridge between the two packages, as the
index ``.npz`` is for search: a directory written by either restores in
the other. So the port keeps the reference's layout byte for byte:

* one ``leaf_<i>.npy`` per leaf, leaf ``i`` being ``jax.tree.flatten``'s
  leaf ``i`` of the same tree: dict keys sorted, a ``NamedTuple`` in field
  order, a tuple or list in order, ``None`` no leaf (:func:`flatten`);
* ``manifest.json`` with every leaf's path, shape, dtype and crc32 of its
  raw bytes, ``n_leaves`` and ``process_index``, fsynced; restore checks
  the crc before the shape and only ``n_leaves`` of the structure. The
  reference's ``treedef`` entry is JAX's repr; the port writes its own
  readable description there (:func:`describe`), which neither restore
  reads;
* a bf16 leaf is written as the reference writes an ``ml_dtypes`` array:
  its raw 2-byte words under a ``<V2`` descr, ``"dtype": "bfloat16"`` in
  the manifest, so the bytes and the crc32 are the reference's. On
  restore such a leaf (``np.load`` gives a ``|V2`` void array) is read
  through a ``uint16`` view into ``torch.bfloat16``;
* a Python ``int`` leaf (the port's ``AdamWState.step``, a host count) is
  written as the reference's 0-d ``int32`` array and read back as an
  ``int``;
* :class:`CheckpointManager` publishes ``step_<n>.tmp/`` by ``os.rename``
  and deletes older steps, keeping ``keep``, only after a write
  succeeded.

:func:`restore_pytree` loads each leaf onto the device and dtype of the
matching leaf of ``tree_like``, or, with ``shardings=`` (the reference's
elastic restore onto a new mesh), as a DTensor on that leaf's mesh and spec
holding the calling rank's block of it: the rows the reference's spec gives
that rank, axes read major to minor as written
(:func:`repro_torch.runtime.sharding.local_rows`), with the placements
that describe those rows (``_StridedShard`` where the spec's axes are not
in mesh order), so the leaf redistributes and gathers as any DTensor.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "flatten",
           "unflatten", "describe"]

_BF16_DESCR = "<V2"      # what np.save writes for an ml_dtypes bfloat16 array


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in flatten(x)]
    return [tree]


def unflatten(tree_like, leaves: list):
    """``tree_like``'s structure holding ``leaves`` (in :func:`flatten`'s
    order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def describe(tree) -> str:
    """A readable description of the tree's structure, leaves as ``*``
    (the manifest's ``treedef`` entry)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={describe(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(describe(x) for x in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array of the leaf's raw values, manifest dtype name)."""
    if _is_int(leaf):
        return np.asarray(leaf, np.int32), "int32"
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"not a checkpoint leaf: {type(leaf).__name__}")
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def save_pytree(tree, directory: str, *, process_index: int = 0) -> dict:
    """Write every leaf + manifest into ``directory`` (must exist)."""
    entries = []
    for i, leaf in enumerate(flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        path = _leaf_path(i)
        _save_leaf(os.path.join(directory, path), arr, dtype)
        entries.append({"path": path, "shape": list(arr.shape),
                        "dtype": dtype, "crc32": _crc(arr)})
    manifest = {
        "treedef": describe(tree),
        "n_leaves": len(entries),
        "leaves": entries,
        "process_index": process_index,
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    return manifest


def _restore_leaf(arr: np.ndarray, dtype: str, like):
    """The leaf read from disk, on ``like``'s device and dtype (a meta
    tensor restores onto the CPU; an ``int`` restores as an ``int``)."""
    if _is_int(like):
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    dev = like.device if like.device.type != "meta" else torch.device("cpu")
    return t.to(device=dev, dtype=like.dtype)


def _flatten_up_to(tree_like, other) -> list:
    """``other``'s node at each leaf position of ``tree_like``, in
    :func:`flatten`'s order (``other`` may stop at any leaf of
    ``tree_like``; None there stands for no sharding)."""
    if tree_like is None:
        return []
    if isinstance(tree_like, dict):
        return [x for k in sorted(tree_like)
                for x in _flatten_up_to(tree_like[k], other[k])]
    if isinstance(tree_like, (tuple, list)):
        return [x for a, b in zip(tree_like, other, strict=True)
                for x in _flatten_up_to(a, b)]
    return [other]


def _shard_leaf(t: torch.Tensor, sharding) -> torch.Tensor:
    """The calling rank's block of ``t`` under ``sharding`` (a
    ``runtime.sharding.NamedSharding`` on a ``DeviceMesh``), as a DTensor."""
    from torch.distributed.tensor import DTensor

    from ..runtime.sharding import local_rows, mesh_axes

    mesh, spec = sharding.mesh, sharding.spec
    coords = dict(zip(mesh_axes(mesh), mesh.get_coordinate()))
    local = t
    for d in range(t.dim()):
        axes = spec.axes(d)
        if axes:
            local = local.narrow(d, *_start_len(
                local_rows(mesh, coords, t.shape[d], axes)))
    return DTensor.from_local(local.contiguous(), mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _start_len(sl: slice) -> tuple[int, int]:
    return sl.start, sl.stop - sl.start


def restore_pytree(tree_like, directory: str, *, shardings=None,
                   verify: bool = True):
    """Restore into the structure of ``tree_like``, whose leaves are
    tensors (a meta tensor stands for a shape and dtype) or ``int``; each
    leaf is loaded onto that leaf's own device and dtype.

    ``shardings``: optional tree of ``NamedSharding`` (or None) matching
    ``tree_like`` up to its leaves; each such leaf is restored as a
    DTensor holding the calling rank's block (see the module docstring),
    whatever mesh wrote it."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = flatten(tree_like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"target structure has {len(leaves)}"
        )
    shard_leaves = (_flatten_up_to(tree_like, shardings)
                    if shardings is not None else [None] * len(leaves))
    out = []
    for i, (spec, sh) in enumerate(zip(leaves, shard_leaves)):
        entry = manifest["leaves"][i]
        arr = np.load(os.path.join(directory, entry["path"]))
        if verify and _crc(arr) != entry["crc32"]:
            raise IOError(f"checksum mismatch in {entry['path']}")
        shape = () if _is_int(spec) else tuple(spec.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != {shape}"
            )
        leaf = _restore_leaf(arr, entry["dtype"], spec)
        out.append(leaf if sh is None else _shard_leaf(leaf, sh))
    return unflatten(tree_like, out)


class CheckpointManager:
    """Directory-of-steps manager with atomic rename + retention."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # ----------------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------- io
    def save(self, step: int, tree, *, extra: dict | None = None) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        save_pytree(tree, tmp)
        if extra is not None:
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()
        return final

    def restore(self, tree_like, *, step: int | None = None):
        """``(tree, step, extra)`` from ``step`` (default: the newest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        tree = restore_pytree(tree_like, d)
        extra_path = os.path.join(d, "extra.json")
        extra = None
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return tree, step, extra

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

"""Rank-local programs over a ``DeviceMesh``: the collectives a step issues
itself on its local shards, where DTensor's op-by-op placement would pick
other ones than the reference's compile.

Every collective is a c10d functional collective on a group made of mesh
dims, so it runs on any backend (the dry-run's ``"fake"`` group, gloo,
NCCL) and the dry-run's :class:`~repro_torch.roofline.StepCounter` charges
it with the reference's ring accounting. A reduction over several mesh dims
is one collective over their flattened group (ring bytes of an all-reduce
depend on the group's size, so two all-reduces over two dims are not the
same bytes as one over both); so is a gather over several dims, as in the
reference's compile (the flattened group's ranks are in mesh order, so
the blocks land in DTensor's mesh order).

A tensor dim sharded over mesh dims ``S`` (``Shard`` placements, DTensor's
mesh order) is cut into ``prod(n_i)`` blocks; the rank's block is its
coordinates over ``S`` read major (first mesh dim) to minor
(:func:`block_of`).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["is_dtensor", "mesh_group", "all_gather", "all_reduce",
           "reduce_scatter", "all_to_all", "permute", "shard_dims",
           "block_of", "split_minor",
           "from_local"]


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def mesh_group(mesh, dims: Sequence[int]):
    """The group of ranks that differ only in mesh dims ``dims``: ``(mesh,
    d)`` for one dim, the flattened sub-mesh for several."""
    dims = tuple(sorted(dims))
    if len(dims) == 1:
        return (mesh, dims[0])
    from torch.utils._python_dispatch import _disable_current_modes

    names = tuple(mesh.mesh_dim_names[d] for d in dims)
    with _disable_current_modes():      # mesh bookkeeping: no traced ops
        return mesh[names]._flatten("_".join(names))


def all_gather(x: torch.Tensor, mesh, dims: Sequence[int],
               gather_dim: int = 0) -> torch.Tensor:
    """``x``'s blocks from every rank of ``dims`` concatenated along
    ``gather_dim`` in mesh order (one all-gather over the flattened
    dims)."""
    import torch.distributed._functional_collectives as funcol

    dims = [d for d in dims if mesh.size(d) > 1]
    if not dims:
        return x
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x.contiguous(), gather_dim,
                                     mesh_group(mesh, dims)))


def all_reduce(x: torch.Tensor, mesh, dims: Sequence[int],
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the ranks of ``dims`` (one collective)."""
    import torch.distributed._functional_collectives as funcol

    dims = [d for d in dims if mesh.size(d) > 1]
    if not dims:
        return x
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op,
                                                mesh_group(mesh, dims)))


def reduce_scatter(x: torch.Tensor, mesh, dims: Sequence[int],
                   scatter_dim: int = 0) -> torch.Tensor:
    """The transpose of :func:`all_gather`: ``x`` summed over the ranks of
    ``dims``, each keeping its own block of ``scatter_dim`` (one
    reduce-scatter per dim, outermost first)."""
    import torch.distributed._functional_collectives as funcol

    scatter = getattr(funcol, "reduce_scatter_single", None) \
        or funcol.reduce_scatter_tensor
    for d in sorted(dims):
        if mesh.size(d) > 1:
            x = funcol.wait_tensor(scatter(x.contiguous(), "sum", scatter_dim,
                                           (mesh, d)))
    return x


def all_to_all(x: torch.Tensor, mesh, dims: Sequence[int], split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` into one block per rank of mesh
    ``dims`` (mesh order), send block ``j`` to rank ``j`` and concatenate
    the received blocks along ``concat_dim`` (one all-to-all over the
    flattened group)."""
    import torch.distributed._functional_collectives as funcol

    dims = [d for d in dims if mesh.size(d) > 1]
    if not dims:
        return x
    n = int(torch.Size([mesh.size(d) for d in dims]).numel())
    parts = torch.stack(x.chunk(n, dim=split_dim))           # (n, ...)
    out = funcol.wait_tensor(funcol.all_to_all_single(
        parts.contiguous(), None, None, mesh_group(mesh, dims)))
    return torch.cat(out.unbind(0), dim=concat_dim)


def permute(x: torch.Tensor, mesh, dims: Sequence[int],
            dest: Sequence[int]) -> torch.Tensor:
    """Each rank of the flattened group of ``dims`` sends ``x`` to rank
    ``dest[rank]`` and receives the ``x`` of the rank that sends to it
    (``dest`` a permutation; an all-to-all whose only non-empty block is
    that one)."""
    import torch.distributed._functional_collectives as funcol

    me = block_of(mesh, dims)
    src = list(dest).index(me)
    n = len(dest)
    rows = x.shape[0]
    send = [rows if j == dest[me] else 0 for j in range(n)]
    recv = [rows if j == src else 0 for j in range(n)]
    return funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), recv, send, mesh_group(mesh, dims)))


def shard_dims(placements, tensor_dim: int) -> list[int]:
    """The mesh dims that shard ``tensor_dim`` (``Shard`` placements)."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(placements)
            if type(p) is Shard and p.dim == tensor_dim]


def block_of(mesh, dims: Sequence[int]) -> int:
    """This rank's block index over mesh dims ``dims`` (mesh order, the
    first dim major)."""
    coord = mesh.get_coordinate()
    b = 0
    for d in sorted(dims):
        b = b * mesh.size(d) + coord[d]
    return b


def split_minor(mesh, dims: Sequence[int], minor: int):
    """``mesh`` seen with the ranks of its leading dims ``dims`` (flattened
    in mesh order) cut into major and minor blocks of ``minor`` ranks ->
    ``(view, major dims, minor dims)``: ``view`` is a ``DeviceMesh`` over
    the same ranks in which the one dim that ``minor`` cuts through is
    split in two (``<name>`` and ``<name>_minor``), so that a collective
    over the minor dims runs among ranks with the same major coordinate
    (cached on ``mesh``; ``mesh`` itself when no dim is split)."""
    dims = sorted(dims)
    if dims != list(range(len(dims))):
        raise ValueError(f"dims {dims} are not the mesh's leading dims")
    sizes = [mesh.size(d) for d in dims]
    inner, d = 1, len(dims)
    while d > 0 and inner * sizes[d - 1] <= minor:
        d -= 1
        inner *= sizes[d]
    if minor % inner or (inner < minor and (
            d == 0 or sizes[d - 1] % (minor // inner))):
        raise ValueError(f"{minor} ranks do not tile the dims {sizes}")
    if inner == minor:                          # whole dims: no new view
        return mesh, list(range(d)), list(range(d, len(dims)))
    cut = minor // inner                        # dim d - 1 splits (-, cut)
    cache = mesh.__dict__.setdefault("_split_views", {})
    key = (tuple(dims), minor)
    if key not in cache:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.utils._python_dispatch import _disable_current_modes

        names = list(mesh.mesh_dim_names)
        shape = list(mesh.mesh.shape)
        shape[d - 1:d] = [shape[d - 1] // cut, cut]
        names[d - 1:d] = [names[d - 1], names[d - 1] + "_minor"]
        with _disable_current_modes():      # mesh bookkeeping: no traced ops
            cache[key] = DeviceMesh(mesh.device_type,
                                    mesh.mesh.reshape(shape),
                                    mesh_dim_names=tuple(names))
    return cache[key], list(range(d)), list(range(d, len(dims) + 1))


def from_local(local: torch.Tensor, mesh, placements, shape=None):
    """A DTensor over ``local`` (no check, no copy); ``shape`` is the global
    shape when a placement's split is uneven or unknown to DTensor."""
    from torch.distributed.tensor import DTensor

    if shape is None:
        return DTensor.from_local(local, mesh, tuple(placements),
                                  run_check=False)
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())

"""Production mesh construction (port of :mod:`repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
device and no process group.

Single pod: 256 chips, mesh ``(data=16, model=16)``.
Multi-pod:  2 pods = 512 chips, mesh ``(pod=2, data=16, model=16)`` — the
``pod`` axis carries only data parallelism and the cross-pod gradient
reduction; ``model`` stays inside a pod.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, whose world size must be the mesh's size: the dry-run
(:mod:`repro_torch.launch.dryrun`) brings up the ``"fake"`` backend at
world size 256 or 512 (:func:`fake_world`), which runs no collective and
touches no card. :class:`AbstractMesh` is the same axes without a group
(the reference's ``jax.sharding.AbstractMesh``): enough for
``Cell.build``, the sharding rules and the roofline's per-chip shapes.
"""

from __future__ import annotations

import contextlib
import math

__all__ = ["AbstractMesh", "PRODUCTION_SHAPES", "make_production_mesh",
           "make_single_device_mesh", "make_host_mesh", "fake_world"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


class AbstractMesh:
    """Axis names and sizes, no devices: ``mesh.shape`` maps name -> size
    in mesh order, as the reference's mesh does."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
        self.shape = dict(zip(axes, (int(s) for s in shape)))
        self.axis_names = tuple(axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _device_mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} "
            f"ranks (repro_torch.launch.mesh.fake_world for a dry-run)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         device_type: str = "cpu"):
    """The production mesh; ``abstract=True`` gives the axes without a
    process group."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    if abstract:
        return AbstractMesh(shape, axes)
    return _device_mesh(shape, axes, device_type)


def make_host_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), *,
                   abstract: bool = False, device_type: str = "cpu"):
    """A small mesh (tests)."""
    if abstract:
        return AbstractMesh(shape, axes)
    return _device_mesh(shape, axes, device_type)


def make_single_device_mesh(*, abstract: bool = True,
                            device_type: str = "cpu"):
    """1-chip mesh with the production axis names (smoke tests)."""
    if abstract:
        return AbstractMesh((1, 1), ("data", "model"))
    return _device_mesh((1, 1), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The ``"fake"`` process group at ``world_size`` for the span of the
    block, destroyed after: collectives on it return at once and move no
    data (a dry-run's stand-in for the production cluster)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()

"""Checkpoints of the port (counterpart of :mod:`repro.checkpoint`): the
same directory layout, so either package restores the other's."""

from .manager import CheckpointManager, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]

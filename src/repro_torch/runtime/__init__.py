"""Runtime substrate of the port (counterpart of :mod:`repro.runtime`):
the fault policies and the sharding rules (:mod:`.sharding`)."""

from .fault import FaultCoordinator, StragglerPolicy

__all__ = ["FaultCoordinator", "StragglerPolicy"]

"""Runtime substrate of the port (counterpart of :mod:`repro.runtime`):
the fault policies. The sharding rules come with the dry-run slice."""

from .fault import FaultCoordinator, StragglerPolicy

__all__ = ["FaultCoordinator", "StragglerPolicy"]

from .analysis import (
    COLLECTIVES,
    HW_H100,
    HW_V5E,
    Hardware,
    StepCounter,
    ring_bytes,
    roofline_terms,
)

__all__ = [
    "COLLECTIVES", "HW_H100", "HW_V5E", "Hardware", "StepCounter",
    "ring_bytes", "roofline_terms",
]

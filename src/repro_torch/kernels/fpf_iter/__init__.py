from .ops import fpf_centers_fused, fpf_iter
from .ref import fpf_iter_ref

__all__ = ["fpf_iter", "fpf_centers_fused", "fpf_iter_ref"]

from .ops import topk_score
from .ref import topk_score_ref

__all__ = ["topk_score", "topk_score_ref"]

from .ops import embed_bag
from .ref import embed_bag_ref

__all__ = ["embed_bag", "embed_bag_ref"]

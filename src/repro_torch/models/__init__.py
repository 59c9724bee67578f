"""Model substrate of the port (counterpart of :mod:`repro.models`): the
embedding tables with the CUDA ``embed_bag`` and the four recsys
architectures. The transformer and GNN families come with later slices."""

from . import embedding, recsys

__all__ = ["embedding", "recsys"]

"""Model substrate of the port (counterpart of :mod:`repro.models`): the
embedding tables with the CUDA ``embed_bag``, the four recsys
architectures and the decoder-only LM family (``transformer``). The GNN
family comes with a later slice."""

from . import embedding, recsys, transformer

__all__ = ["embedding", "recsys", "transformer"]

"""Model substrate of the port (counterpart of :mod:`repro.models`): the
embedding tables with the CUDA ``embed_bag``, the four recsys
architectures, the decoder-only LM family (``transformer``) and the GCN
(``gnn``)."""

from . import embedding, gnn, recsys, transformer

__all__ = ["embedding", "gnn", "recsys", "transformer"]

"""Data pipelines of the port (counterpart of :mod:`repro.data`), copied
numpy so that one seed gives the reference's data bit for bit:

corpus       3-field Citeseer-like document corpus
lm           Zipf token streams for LM training, deterministic per shard
recsys_data  click-log generator: dense + multi-hot sparse features, labels
graphs       Cora-like SBM, power-law graphs, molecule batches, k-hop sampler
"""

from .corpus import CorpusConfig, make_corpus
from .graphs import (
    GraphData,
    cora_like,
    molecule_batch,
    power_law_graph,
    sample_khop,
    to_csr,
)
from .lm import TokenStream, lm_batch
from .recsys_data import RecsysBatchConfig, click_batch, history_batch

__all__ = [
    "CorpusConfig", "make_corpus",
    "TokenStream", "lm_batch",
    "RecsysBatchConfig", "click_batch", "history_batch",
    "GraphData", "cora_like", "molecule_batch", "power_law_graph",
    "sample_khop", "to_csr",
]

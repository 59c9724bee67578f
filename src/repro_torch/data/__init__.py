from .corpus import CorpusConfig, make_corpus
from .lm import TokenStream, lm_batch
from .recsys_data import RecsysBatchConfig, click_batch, history_batch

__all__ = ["CorpusConfig", "make_corpus", "RecsysBatchConfig", "click_batch",
           "history_batch", "TokenStream", "lm_batch"]

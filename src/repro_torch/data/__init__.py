from .corpus import CorpusConfig, make_corpus

__all__ = ["CorpusConfig", "make_corpus"]

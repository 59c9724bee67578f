"""Synthetic Citeseer-like multi-field corpus (port of
:mod:`repro.data.corpus`).

Pure numpy with a seeded ``np.random.default_rng``, copied rather than
imported so the port needs nothing of the JAX package: for the same
:class:`CorpusConfig` it returns a corpus bit-identical to the reference's.
A latent topic model (Zipf-weighted salient terms per topic and field,
1–3 topics per document with Dirichlet weights, plus rare idiosyncratic
terms) is feature-hashed into fixed per-field dimensions and every field
vector is unit-normalised.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.fields import FieldSpec

__all__ = ["CorpusConfig", "make_corpus"]


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 20_000
    field_names: tuple[str, ...] = ("title", "authors", "abstract")
    field_dims: tuple[int, ...] = (512, 512, 1024)     # hashed dims
    vocab_sizes: tuple[int, ...] = (8_000, 12_000, 30_000)
    terms_per_field: tuple[int, ...] = (8, 3, 80)      # ~ title/authors/abstract
    n_topics: int = 64
    salient_per_topic: int = 60                         # salient terms per topic/field
    topic_mix_alpha: float = 0.4                        # Dirichlet concentration
    noise_terms: tuple[int, ...] = (2, 1, 12)           # rare idiosyncratic terms
    seed: int = 0

    @property
    def spec(self) -> FieldSpec:
        return FieldSpec(names=self.field_names, dims=self.field_dims)


def _hash_terms(rng: np.random.Generator, vocab: int, dim: int):
    """Feature hashing: term id -> (coordinate, sign)."""
    coords = rng.integers(0, dim, size=vocab)
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=vocab)
    return coords.astype(np.int64), signs


def _topic_field_matrix(
    rng: np.random.Generator,
    n_topics: int,
    vocab: int,
    dim: int,
    salient: int,
    idf: np.ndarray,
    coords: np.ndarray,
    signs: np.ndarray,
) -> np.ndarray:
    """(n_topics, dim) hashed tf-idf vectors of each topic's salient terms."""
    mats = np.zeros((n_topics, dim), np.float32)
    tf = 1.0 / np.arange(1, salient + 1, dtype=np.float32)
    for t in range(n_topics):
        terms = rng.choice(vocab, size=salient, replace=False)
        w = tf * idf[terms]
        np.add.at(mats[t], coords[terms], signs[terms] * w)
    norms = np.linalg.norm(mats, axis=1, keepdims=True)
    return mats / np.maximum(norms, 1e-12)


def make_corpus(cfg: CorpusConfig):
    """Generate the corpus: ``(docs (n, D) float32 numpy, spec,
    doc_topics (n, n_topics))`` — the same arrays as the reference."""
    rng = np.random.default_rng(cfg.seed)
    spec = cfg.spec
    n, s = cfg.n_docs, spec.s

    n_active = rng.integers(1, 4, size=n)
    doc_topics = np.zeros((n, cfg.n_topics), np.float32)
    active = rng.integers(0, cfg.n_topics, size=(n, 3))
    mix = rng.dirichlet([cfg.topic_mix_alpha] * 3, size=n).astype(np.float32)
    for j in range(3):
        live = n_active > j
        np.add.at(doc_topics, (np.nonzero(live)[0], active[live, j]), mix[live, j])
    doc_topics /= np.maximum(doc_topics.sum(1, keepdims=True), 1e-12)

    fields = []
    for f in range(s):
        vocab, dim = cfg.vocab_sizes[f], cfg.field_dims[f]
        coords, signs = _hash_terms(rng, vocab, dim)
        ranks = np.arange(1, vocab + 1, dtype=np.float32)
        df = np.maximum(n * (ranks ** -1.1) / np.sum(ranks ** -1.1) * 40, 1.0)
        idf = np.log(n / df).astype(np.float32)
        topic_mat = _topic_field_matrix(
            rng, cfg.n_topics, vocab, dim, cfg.salient_per_topic, idf, coords, signs
        )
        x = doc_topics @ topic_mat * float(cfg.terms_per_field[f])

        k_noise = cfg.noise_terms[f]
        if k_noise > 0:
            noise_terms = rng.integers(vocab // 4, vocab, size=(n, k_noise))
            w = idf[noise_terms]
            c = coords[noise_terms]
            sgn = signs[noise_terms]
            rows = np.repeat(np.arange(n), k_noise)
            np.add.at(x, (rows, c.reshape(-1)), (sgn * w).reshape(-1))

        norms = np.linalg.norm(x, axis=1, keepdims=True)
        fields.append(x / np.maximum(norms, 1e-12))

    docs = np.concatenate(fields, axis=1).astype(np.float32)
    return docs, spec, doc_topics

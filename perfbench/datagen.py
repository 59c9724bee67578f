"""Inputs of every cell, drawn on the device from ``--seed``.

The yardstick's own copies of the program's data generators, so that a
change to the program cannot change what it is measured on:

* :func:`citeseer_corpus` is the synthetic Citeseer-like corpus of
  ``repro_torch.data.corpus.make_corpus`` (a latent topic model of
  Zipf-weighted salient terms, 1-3 topics a document with Dirichlet weights,
  rare idiosyncratic terms, feature-hashed into fixed per-field dimensions,
  every field unit-normalised), drawn with torch on the card instead of
  numpy on the host. It is not bit-identical to the program's generator;
  both sides of every comparison get the same arrays.
* :func:`clustered_shard` is ``chip_smoke.py``'s ``paper_shard``: each row a
  random topic vector plus ``noise`` times its own normal draw, unit-norm per
  field, stored in the serving dtype.
* :func:`dirichlet` draws per-query field weights.
* :func:`traffic_pool` is the one generator every traffic file goes
  through: like-documents and weights for every batch of a run.

Sums that several draws add into one place run one draw at a time, each
touching a place at most once, so the same seed gives the same arrays bit
for bit on the card.
"""

from __future__ import annotations

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def generator(seed: int, stream: int, dev) -> torch.Generator:
    """A generator on ``dev`` for one named use (``stream``) of a run's
    seed: any whole ``seed`` up to 64 bits, mixed so that streams of
    neighbouring seeds do not overlap."""
    mixed = (int(seed) * _GOLDEN + int(stream) * 0xBF58476D1CE4E5B9) % 2**63
    return torch.Generator(device=dev).manual_seed(mixed)


def field_slices(dims):
    out, lo = [], 0
    for d in dims:
        out.append(slice(lo, lo + d))
        lo += d
    return out


def normalize_fields(x: torch.Tensor, dims) -> torch.Tensor:
    """Unit-normalise every field block of ``x (..., D)`` in place; zero
    blocks stay zero."""
    for sl in field_slices(dims):
        f = x[..., sl]
        f.div_(torch.linalg.vector_norm(f, dim=-1, keepdim=True)
               .clamp_(min=1e-12))
    return x


def dirichlet(alpha, n: int, g: torch.Generator, dev) -> torch.Tensor:
    """``(n, len(alpha))`` float32 Dirichlet draws (normalised gammas)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    shape = torch.ones((n, a.numel()), device=dev) * a
    gam = torch._standard_gamma(shape, generator=g)
    return gam / gam.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def _sample_without_replacement(rows: int, pool: int, size: int,
                                g: torch.Generator, dev) -> torch.Tensor:
    """``(rows, size)`` int64: each row ``size`` distinct values of
    ``range(pool)``."""
    keys = torch.rand((rows, pool), generator=g, device=dev)
    return torch.topk(keys, size, dim=-1).indices


def citeseer_corpus(cfg: dict, seed: int, dev) -> torch.Tensor:
    """The ``(n_docs, D)`` float32 corpus of a ``citeseer_topics``
    configuration (see the module docstring)."""
    n, n_topics = int(cfg["n_docs"]), int(cfg["n_topics"])
    dims = cfg["field_dims"]
    g = generator(seed, 1, dev)
    rows = torch.arange(n, device=dev)
    n_active = torch.randint(1, 4, (n,), generator=g, device=dev)
    active = torch.randint(0, n_topics, (n, 3), generator=g, device=dev)
    mix = dirichlet([cfg["topic_mix_alpha"]] * 3, n, g, dev)
    doc_topics = torch.zeros((n, n_topics), device=dev)
    for j in range(3):
        doc_topics.index_put_((rows, active[:, j]),
                              mix[:, j] * (n_active > j), accumulate=True)
    doc_topics /= doc_topics.sum(1, keepdim=True).clamp(min=1e-12)
    fields = []
    for f, dim in enumerate(dims):
        vocab = int(cfg["vocab_sizes"][f])
        coords = torch.randint(0, dim, (vocab,), generator=g, device=dev)
        signs = torch.randint(0, 2, (vocab,), generator=g,
                              device=dev).float() * 2 - 1
        ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=dev)
        zipf = ranks ** -1.1
        df = torch.clamp(n * zipf / zipf.sum() * 40, min=1.0)
        idf = torch.log(n / df)
        salient = int(cfg["salient_per_topic"])
        terms = _sample_without_replacement(n_topics, vocab, salient, g, dev)
        tf = 1.0 / torch.arange(1, salient + 1, dtype=torch.float32,
                                device=dev)
        topic_mat = torch.zeros((n_topics, dim), device=dev)
        trow = torch.arange(n_topics, device=dev)
        for j in range(salient):
            t = terms[:, j]
            topic_mat.index_put_((trow, coords[t]), signs[t] * tf[j] * idf[t],
                                 accumulate=True)
        topic_mat /= torch.linalg.vector_norm(
            topic_mat, dim=1, keepdim=True).clamp(min=1e-12)
        x = doc_topics @ topic_mat
        x *= float(cfg["terms_per_field"][f])
        lo = vocab // 4
        for _ in range(int(cfg["noise_terms"][f])):
            t = torch.randint(lo, vocab, (n,), generator=g, device=dev)
            x.index_put_((rows, coords[t]), signs[t] * idf[t],
                         accumulate=True)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
        fields.append(x)
    return torch.cat(fields, dim=1)


def clustered_shard(cfg: dict, seed: int, dev,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """The ``(n_rows, D)`` clustered shard of a ``clustered_topics``
    configuration, in ``dtype``, drawn ``chunk_rows`` rows at a time."""
    n, dims = int(cfg["n_rows"]), cfg["field_dims"]
    d = sum(dims)
    g = generator(seed, 2, dev)
    topics = torch.randn((int(cfg["n_topics"]), d), generator=g, device=dev)
    docs = torch.empty((n, d), dtype=dtype, device=dev)
    step = int(cfg["chunk_rows"])
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        t = torch.randint(0, topics.shape[0], (hi - lo,), generator=g,
                          device=dev)
        x = torch.randn((hi - lo, d), generator=g, device=dev)
        x.mul_(float(cfg["noise"])).add_(topics[t])
        docs[lo:hi] = normalize_fields(x, dims).to(dtype)
    return docs


def traffic_pool(traffic: dict, n_rows: int, n_batches: int, seed: int,
                 n_fields: int, dev) -> dict:
    """Every batch a run can send, drawn at once: ``like (n_batches, batch)``
    int64 like-documents, uniform over the ``n_rows`` rows, and ``weights
    (n_batches, batch, n_fields)`` float32 field weights from the traffic's
    Dirichlet ``alpha``. Batch ``i`` of every seed has the same sizes."""
    b = int(traffic["batch"])
    g = generator(seed, 3, dev)
    like = torch.randint(0, n_rows, (n_batches, b), generator=g, device=dev)
    w = dirichlet(traffic["alpha"], n_batches * b, g, dev)
    return {"like": like, "weights": w.reshape(n_batches, b, n_fields)}


def pool_batch(pool: dict, i: int):
    """Batch ``i`` of a run: ``(like (batch,), weights (batch, s))``; a
    window longer than the pool starts it again (the same queries, which no
    cache of the program keeps)."""
    j = i % pool["like"].shape[0]
    return pool["like"][j], pool["weights"][j]


def pool_chunk(pool: dict, lo: int, hi: int):
    """Batches ``lo .. hi - 1`` flattened: ``(like (q,), weights (q, s))``."""
    n, _, s = pool["weights"].shape
    idx = torch.arange(lo, hi, device=pool["like"].device) % n
    return pool["like"][idx].reshape(-1), pool["weights"][idx].reshape(-1, s)


def build_draws(n_rows: int, sample: int, n_clusterings: int,
                n_builds: int, seed: int, dev) -> list:
    """For each of ``n_builds`` builds, one draw per clustering: the FPF
    sample (``sample`` distinct rows) and its first centre, as host tensors
    (what ``ClusterPruneIndex.build(draws=...)`` takes)."""
    g = generator(seed, 4, dev)
    out = []
    for _ in range(n_builds):
        per = []
        for _ in range(n_clusterings):
            idx = torch.randperm(n_rows, generator=g, device=dev)[:sample]
            first = torch.randint(0, sample, (1,), generator=g, device=dev)
            per.append({"sample_idx": idx.cpu(), "first": int(first)})
        out.append(per)
    return out


def host_results(traffic: dict):
    """Host buffers for every batch's ``(scores, ids)``: each batch's
    results are copied into its row, so the window allocates nothing on the
    host."""
    shape = (int(traffic["pool_batches"]), int(traffic["batch"]),
             int(traffic["k"]))
    return (torch.empty(shape, dtype=torch.float32),
            torch.empty(shape, dtype=torch.int32))


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` float32 rounded to TF32's 10-bit mantissa (nearest, ties to
    even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0x0FFF + lsb) & ~0x1FFF
    return out.view(torch.float32)

"""The plain reference against the port's own plain paths on a tiny corpus
(CPU): the two are written apart, so agreement checks both. Also the
roofline arithmetic against PERF.md's worked bounds."""

import numpy as np
import pytest
import torch

from perfbench import datagen, roofline
from perfbench.reference import index_ref, search_ref

DIMS = [16, 16, 32]
CFG = {"n_docs": 500, "n_topics": 12, "field_dims": DIMS,
       "vocab_sizes": [300, 400, 900], "terms_per_field": [8, 3, 80],
       "salient_per_topic": 20, "topic_mix_alpha": 1.0,
       "noise_terms": [4, 2, 24]}


@pytest.fixture(scope="module")
def built():
    from repro_torch.core.fields import FieldSpec
    from repro_torch.core.index import ClusterPruneIndex

    dev = torch.device("cpu")
    docs = datagen.citeseer_corpus(CFG, 7, dev)
    draws = datagen.build_draws(500, 71, 3, 1, 7, dev)[0]
    spec = FieldSpec(names=("t", "a", "b"), dims=tuple(DIMS))
    index = ClusterPruneIndex.build(docs, spec, 10, n_clusterings=3,
                                    method="fpf_fused", pack_major=True,
                                    draws=draws, device=dev)
    return docs, draws, index


def test_corpus_is_seeded_and_unit_per_field():
    a = datagen.citeseer_corpus(CFG, 3, torch.device("cpu"))
    b = datagen.citeseer_corpus(CFG, 3, torch.device("cpu"))
    assert torch.equal(a, b)
    lo = 0
    for d in DIMS:
        norms = torch.linalg.vector_norm(a[:, lo:lo + d], dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
        lo += d


def test_index_checks_read_nought_on_the_ports_build(built):
    from repro_torch.kernels.fpf_iter import fpf_centers_fused

    docs, draws, index = built
    for t, draw in enumerate(draws):
        x = docs[draw["sample_idx"]]
        c = fpf_centers_fused(x.contiguous(), 10, draw["first"]).long()
        assert float(index_ref.fpf_round_gaps(x, c).max()) <= 1e-6
        gap, not_member = index_ref.medoid_gap(docs, x[c], index.leaders[t],
                                               eps=1e-5)
        assert gap <= 1e-6 and not_member == 0
        assign = torch.as_tensor(index.assign[t])
        assert index_ref.assign_gap(docs, index.leaders[t], assign) <= 1e-6
        assert index_ref.bucket_mismatches(assign, index.buckets[t],
                                           index.counts[t], 500) == 0
    data, ids, _ = index.ensure_bucket_major()
    assert index_ref.pack_mismatches(docs, data, ids, index.buckets,
                                     500) == 0


def test_a_wrong_fpf_centre_reads_far(built):
    from repro_torch.kernels.fpf_iter import fpf_centers_fused

    docs, draws, _ = built
    x = docs[draws[0]["sample_idx"]]
    c = fpf_centers_fused(x.contiguous(), 10, draws[0]["first"]).long()
    c[5] = c[4]
    assert float(index_ref.fpf_round_gaps(x, c).max()) > 0.1


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_search_answers_agree_with_the_ports_plain_paths(built, backend):
    docs, _, index = built
    g = datagen.generator(11, 3, torch.device("cpu"))
    like = torch.randint(0, 500, (24,), generator=g)
    w = datagen.dirichlet([1.0, 1.0, 1.0], 24, g, torch.device("cpu"))
    s, i, _ = index.search_weighted(docs[like], w, probes=6, k=10,
                                    exclude=like, backend=backend)
    qw = search_ref.weighted_query(docs[like], w, DIMS)
    sims = (qw @ index.leaders.reshape(30, -1).T).reshape(-1, 3, 10)
    certain, possible = search_ref.probe_sets(sims, (2, 2, 2), 1e-5)
    r = search_ref.judge(search_ref.full_scores(qw, docs), s, i,
                         search_ref.member_mask(certain, index.buckets, 500),
                         search_ref.member_mask(possible, index.buckets, 500),
                         like)
    assert r["bad"] == 0
    assert r["score_err"] <= 1e-6 and r["rank_gap"] <= 1e-6


def test_brute_force_agrees_with_the_ports_plain_topk():
    from repro_torch.kernels.topk_score import topk_score_ref

    cfg = {"n_rows": 800, "field_dims": DIMS, "n_topics": 16, "noise": 1.0,
           "chunk_rows": 256}
    docs = datagen.clustered_shard(cfg, 5, torch.device("cpu"))
    like = torch.arange(0, 800, 50)
    w = torch.full((16, 3), 1 / 3)
    qw = search_ref.weighted_query(docs[like], w, DIMS).to(torch.bfloat16)
    s, i = topk_score_ref(qw, docs, k=10, exclude=like.to(torch.int32),
                          round_bf16=True)
    scores = search_ref.full_scores(qw, docs).to(torch.bfloat16).float()
    every = torch.ones_like(scores, dtype=torch.bool)
    r = search_ref.judge(scores, s, i, every, every, like, ulps=True)
    assert r["bad"] == 0 and r["far_scores"] == 0 and r["far_ranks"] == 0


def test_roofline_matches_the_worked_bounds():
    nq, n, d, k = 256, 390_624, 4096, 10
    topk = roofline.bound_s(n * d * 2 + nq * d * 2 + nq * 4 + nq * k * 8,
                            {"bf16": 2 * nq * n * d})
    assert topk * 1e3 == pytest.approx(0.956, abs=5e-4)
    m, d2, rounds = 5622, 2048, 315
    fpf = roofline.bound_s(m * d2 * 4 / rounds, {"fp32": 2 * m * d2})
    assert fpf * 1e3 == pytest.approx(0.000344, rel=1e-3)
    assert roofline.share_pct({"bytes": 3.35e12, "flops": {}}, 2.0) == 50.0
    assert roofline.share_pct(None, 1.0) is None


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.14159], dtype=torch.float32)
    y = datagen.round_to_tf32(x)
    assert y[0] == x[0]
    assert y[1] == 1.0                      # tie to even
    assert y[2] == 1.0 + 2**-9              # tie to even, upward
    assert abs(float(y[3]) + 3.14159) < 2**-9 * 4
    bits = y.view(torch.int32) & 0x1FFF
    assert np.all(bits.numpy() == 0)

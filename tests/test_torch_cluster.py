"""PyTorch port, build side: FPF sampling size, the FPF rounds, the
assignment and medoid tail, and whole clusterings against the JAX
reference with the reference's random draws injected."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core.cluster import _medoids as r_medoids  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core.cluster import _medoids as p_medoids  # noqa: E402


def _np(x):
    return np.array(x)          # writable copy for torch.as_tensor


@pytest.mark.parametrize("k,n", [(10, 1200), (24, 1500), (316, 100_000),
                                 (7, 3), (1000, 999_983)])
def test_fpf_sample_size_is_float32_ceil_sqrt(k, n):
    want = int(jnp.ceil(jnp.sqrt(k * n)))
    from repro_torch.core.cluster import fpf_sample_size

    assert fpf_sample_size(k, n) == want


def test_registry_and_auto_pick():
    assert set(P.available_clusterers()) == {"fpf", "fpf_fused", "kmeans",
                                             "random"}
    assert P.get_clusterer("auto", device="cpu").name == "fpf"
    assert P.get_clusterer("auto", device="cuda").name == "fpf_fused"
    with pytest.raises(ValueError, match="unknown clusterer"):
        P.get_clusterer("does-not-exist")


def test_assign_and_medoids_match(random_corpus):
    x, _ = random_corpus
    xn = _np(x)
    rng = np.random.default_rng(0)
    reps = xn[rng.choice(len(xn), 12, replace=False)]
    leaders = np.stack([reps, xn[rng.choice(len(xn), 12, replace=False)]])
    ra, rs = R.assign_to_centers_multi(x, jnp.asarray(leaders), chunk=500)
    pa, ps = P.assign_to_centers_multi(torch.as_tensor(xn),
                                       torch.as_tensor(leaders), chunk=500)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), atol=1e-5)
    sims = np.einsum("nd,tkd->tnk", xn.astype(np.float64), leaders)
    top2 = np.sort(sims, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(pa.numpy()[clear], np.asarray(ra)[clear])
    # medoids from the same assignment (one cluster left empty on purpose)
    a = np.asarray(ra[0]).copy()
    a[a == 3] = 4
    r_rep, r_cnt = r_medoids(x, jnp.asarray(a), 12)
    p_rep, p_cnt = p_medoids(torch.as_tensor(xn), torch.as_tensor(a), 12)
    np.testing.assert_allclose(p_cnt.numpy(), np.asarray(r_cnt))
    np.testing.assert_array_equal(p_rep.numpy(), np.asarray(r_rep))


def _reference_draws(x, k, key):
    """The sample and first center the reference's FPFClusterer draws."""
    n = x.shape[0]
    size = max(min(int(jnp.ceil(jnp.sqrt(k * n))), n), k)
    skey, fkey = jax.random.split(key)
    sample_idx = np.asarray(jax.random.permutation(skey, n)[:size])
    first = int(jax.random.randint(fkey, (), 0, size, dtype=jnp.int32))
    return sample_idx, first


@pytest.mark.parametrize("name", ["fpf", "fpf_fused"])
def test_fpf_clusterer_matches_reference_with_injected_draws(
        random_corpus, name):
    """Same sample and first center as the reference: equal centers, equal
    representatives, and equal assignment on every point whose best leader
    beats the second by more than 1e-5."""
    x, _ = random_corpus
    k, key = 10, jax.random.PRNGKey(2)
    ref = R.get_clusterer("fpf").cluster(x, k, key)
    sample_idx, first = _reference_draws(x, k, key)
    xs = x[jnp.asarray(sample_idx)]
    want_centers = np.asarray(R.fpf_centers(xs, k, jax.random.split(key)[1]))
    xt = torch.as_tensor(_np(x))
    clusterer = P.get_clusterer(name)
    got_centers = clusterer._centers(xt[torch.as_tensor(sample_idx)]
                                     .contiguous(), k, first)
    assert got_centers.tolist() == want_centers.tolist()
    res = clusterer.cluster(xt, k, sample_idx=sample_idx, first=first)
    np.testing.assert_allclose(res.reps.numpy(), np.asarray(ref.reps),
                               atol=1e-6)
    reps = np.asarray(ref.reps, np.float64)
    sims = _np(x).astype(np.float64) @ reps.T
    top2 = np.sort(sims, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(res.assign.numpy()[clear],
                                  np.asarray(ref.assign)[clear])
    np.testing.assert_allclose(res.counts.numpy(), np.asarray(ref.counts))
    assert float(res.max_radius) == pytest.approx(float(ref.max_radius),
                                                  abs=1e-5)


def test_port_build_fpf_equals_fpf_fused_plain(random_corpus):
    """On the CPU the fused clusterer runs the kernel's plain version, whose
    arithmetic is the plain FPF rounds': one seed, one index."""
    x, spec_j = random_corpus
    spec = P.FieldSpec(spec_j.names, spec_j.dims)
    a = P.ClusterPruneIndex.build(_np(x), spec, 12, method="fpf",
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(4))
    b = P.ClusterPruneIndex.build(_np(x), spec, 12, method="fpf_fused",
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(4))
    assert (a.method, b.method) == ("fpf", "fpf_fused")
    assert torch.equal(a.buckets, b.buckets)
    assert torch.equal(a.leaders, b.leaders)
    assert a.buckets.shape[:2] == (3, 12) and a.buckets.shape[2] % 8 == 0
    # every doc sits in exactly one bucket of every clustering
    for t in range(3):
        live = a.buckets[t][a.buckets[t] < a.n_docs]
        assert sorted(live.tolist()) == list(range(a.n_docs))
    assert np.array_equal(a.assignments(), a.assign)

"""PyTorch port, the sharded backend: ``repro_torch.core.distributed`` and
``ShardedEngine`` against the JAX reference on the same inputs, at the
reference's own small sizes (FieldSpec 32/32, n = 1024 and 1019, K = 16,
T = 3). The reference builds and saves each index; the port loads it and
runs at S = 1, 3 and 8 shards on the CPU (the plain versions of the
kernels). In-process, the reference runs on its one CPU device; one
subprocess runs the reference's ``ShardedEngine`` on 8 forced host devices
for its bf16 and int8 answers."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core.engine import _exact_rescore as r_exact_rescore  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core import distributed as PD  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_CL, T = 16, 3
SHARDS = (1, 3, 8)
PROBES, K = 6, 10
# fp32 scores of the port against the reference: 64-term fp32 dots summed
# in another order (the reference's own sharded tests use 1e-5).
ATOL = 1e-5


def _np(x):
    return np.array(x)          # writable copy for torch.as_tensor


def _reference_index(n):
    spec = R.FieldSpec(names=("a", "b"), dims=(32, 32))
    docs = R.normalize_fields(
        jax.random.normal(jax.random.PRNGKey(0), (n, 64)), spec)
    idx = R.ClusterPruneIndex.build(docs, spec, K_CL, n_clusterings=T,
                                    method="fpf", key=jax.random.PRNGKey(0))
    return idx, spec


@pytest.fixture(scope="module", params=[1024, 1019], ids=["n1024", "n1019"])
def saved(request, tmp_path_factory):
    """``(n, path, docs (n, 64) numpy, qw (5, 64) numpy)``: the
    reference's index over n docs, saved for the port, and its five
    weighted queries (docs 10..14, weights 0.7 / 0.3)."""
    n = request.param
    idx, spec = _reference_index(n)
    path = tmp_path_factory.mktemp(f"sharded{n}") / "index.npz"
    idx.save(path)
    qw = R.weighted_query(idx.docs[10:15],
                          jnp.tile(jnp.asarray([[0.7, 0.3]]), (5, 1)), spec)
    return n, path, _np(idx.docs), _np(qw)


def _port(path):
    return P.ClusterPruneIndex.load(path, device="cpu")


def _padded_assign(index, n_shards):
    n = index.n_docs
    n_pad = PD.shard_rows(n, n_shards) * n_shards
    return np.pad(index.assignments(), ((0, 0), (0, n_pad - n)),
                  constant_values=-1), n_pad


@pytest.mark.parametrize("n,s", [(1024, 8), (1019, 8), (1019, 3), (5, 8),
                                 (1, 1), (17, 4)])
def test_shard_rows_matches_reference(n, s):
    assert PD.shard_rows(n, s) == RD.shard_rows(n, s)
    assert PD.shard_rows(n, s) * s >= n


@pytest.mark.parametrize("n_shards", SHARDS)
def test_build_local_buckets_bit_equal(saved, n_shards):
    _, path, _, _ = saved
    index = _port(path)
    a_pad, n_pad = _padded_assign(index, n_shards)
    want = RD.build_local_buckets(a_pad, n_pad, n_shards, K_CL)
    got = PD.build_local_buckets(a_pad, n_pad, n_shards, K_CL)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        PD.build_local_buckets(a_pad[:, :7], 7, 2, K_CL)


@pytest.mark.parametrize("pack_dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_pack_local_bucket_major_matches_reference(saved, n_shards,
                                                   pack_dtype):
    """ids equal; fp32 and bf16 data bit-equal; int8 values equal and
    scales within 1 ulp (absmax / 127 in another order of operations)."""
    _, path, docs, _ = saved
    index = _port(path)
    assign = index.assignments()
    r_data, r_ids, r_sc, r_nl = RD.pack_local_bucket_major(
        jnp.asarray(docs), assign, K_CL, n_shards, dtype=pack_dtype)
    data, ids, sc, n_local = PD.pack_local_bucket_major(
        index.docs, assign, K_CL, n_shards, dtype=pack_dtype)
    assert n_local == r_nl
    assert tuple(data.shape) == tuple(r_data.shape)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    if pack_dtype == "int8":
        assert data.dtype == torch.int8
        np.testing.assert_array_equal(data.numpy(), np.asarray(r_data))
        np.testing.assert_array_max_ulp(sc.numpy(), np.asarray(r_sc),
                                        maxulp=1)
    else:
        assert sc is None and r_sc is None
        np.testing.assert_array_equal(
            data.float().numpy(), np.asarray(r_data.astype(jnp.float32)))
    # the index caches it per shard count; a mutation drops it
    assert index.ensure_local_bucket_major(n_shards) is \
        index.ensure_local_bucket_major(n_shards)
    index.remove_documents([0])
    assert "_local_bucket_major" not in index.__dict__


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_docs_views_and_padding(saved, n_shards):
    n, path, _, _ = saved
    index = _port(path)
    shards = PD.shard_docs(index.docs, n_shards)
    n_local = PD.shard_rows(n, n_shards)
    assert all(tuple(b.shape) == (n_local, 64) for b in shards)
    torch.testing.assert_close(torch.cat(shards)[:n], index.docs, atol=0,
                               rtol=0)
    assert not torch.cat(shards)[n:].any()
    full = [b for s, b in enumerate(shards) if (s + 1) * n_local <= n]
    assert all(b.data_ptr() == index.docs[s * n_local].data_ptr()
               for s, b in enumerate(full))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_brute_topk_matches_reference(saved, n_shards):
    n, path, docs, qw = saved
    index = _port(path)
    ex = np.asarray([10, 11, 600, 1018, -1], np.int32)
    want_s, want_i = R.brute_force_topk(jnp.asarray(docs), jnp.asarray(qw),
                                        K, exclude=jnp.asarray(ex))
    s, i = PD.distributed_brute_topk(
        PD.shard_docs(index.docs, n_shards), torch.as_tensor(qw), k=K,
        exclude=torch.as_tensor(ex), n_valid=n)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=ATOL)
    # k past the eligible rows: -inf / -1, never a sentinel pad row
    s, i = PD.distributed_brute_topk(
        PD.shard_docs(index.docs[:5], n_shards), torch.as_tensor(qw), k=7,
        n_valid=5)
    assert (i[:, 5:] == -1).all() and torch.isinf(s[:, 5:]).all()
    assert set(i[:, :5].reshape(-1).tolist()) <= set(range(5))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_exact_rescore_matches_reference(saved, n_shards):
    """Candidates with -1 fillers: the sharded MAX-reduce rescore equals
    the reference's single-device ``_exact_rescore``."""
    n, path, docs, qw = saved
    index = _port(path)
    rng = np.random.default_rng(1)
    ids = rng.choice(n, (5, 30), replace=False if n >= 150 else True)
    ids = ids.astype(np.int32)
    ids[:, -7:] = -1
    ids[2, :] = -1
    ids[3, :25] = -1
    want = r_exact_rescore(jnp.asarray(docs), jnp.asarray(qw),
                           jnp.asarray(ids), K)
    got = PD.distributed_exact_rescore(
        PD.shard_docs(index.docs, n_shards), torch.as_tensor(qw),
        torch.as_tensor(ids), k=K, n_local=PD.shard_rows(n, n_shards))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_index_search_matches_reference(saved, n_shards):
    """The gather oracle at S shards against the reference's on its
    one-device mesh: the shards' candidates are the global candidates, so
    the merged top-k is the same, exclusion included."""
    n, path, docs, qw = saved
    index = _port(path)
    mesh = jax.make_mesh((1,), ("data",))
    r_bl = RD.build_local_buckets(index.assignments(), n, 1, K_CL)
    ex = np.asarray([10, 11, 12, 13, 14], np.int32)
    want = RD.distributed_index_search(
        mesh, jnp.asarray(docs), jnp.asarray(_np(index.leaders)),
        jnp.asarray(r_bl), jnp.asarray(qw), probes_t=(2, 2, 2), k=K,
        shard_axes=("data",), exclude=jnp.asarray(ex))
    a_pad, n_pad = _padded_assign(index, n_shards)
    bl = PD.build_local_buckets(a_pad, n_pad, n_shards, K_CL)
    got = PD.distributed_index_search(
        PD.shard_docs(index.docs, n_shards), index.leaders, bl,
        torch.as_tensor(qw), probes_t=(2, 2, 2), k=K,
        exclude=torch.as_tensor(ex))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)
    # and it is the reference engine's answer on the same probes
    r = R.get_engine(R.ClusterPruneIndex.load(path), "reference").search(
        jnp.asarray(qw), probes=PROBES, k=K, exclude=jnp.asarray(ex))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(r[1]))


@pytest.fixture(scope="module")
def prefilter_case(small_corpus):
    """``tests/test_prefilter.py``'s inputs: the reference's index (K = 40)
    over the 1500-doc corpus, 24 queries, their brute-force top-10, and one
    numpy JL projection (D -> D/2) applied to corpus and queries."""
    docs, spec, _ = small_corpus
    n = docs.shape[0]
    idx = R.ClusterPruneIndex.build(docs, spec, 40, n_clusterings=3,
                                    method="fpf")
    rng = np.random.default_rng(0)
    qids = rng.choice(n, 24, replace=False)
    w = np.tile(np.asarray([[0.5, 0.2, 0.3]], np.float32), (24, 1))
    qw = _np(R.weighted_query(docs[jnp.asarray(qids)], jnp.asarray(w),
                              spec))
    _, gt_i = R.brute_force_topk(docs, jnp.asarray(qw), 10)
    d = spec.total_dim
    proj = (np.random.default_rng(42).normal(size=(d, d // 2))
            * (d // 2) ** -0.5).astype(np.float32)
    docs_np = _np(docs)
    return dict(idx=idx, docs=docs_np, qw=qw, gt_i=gt_i, dp=docs_np @ proj,
                qp=qw @ proj, assign=idx.assignments())


@pytest.mark.parametrize("n_shards", SHARDS)
def test_prefilter_recall_with_injected_projection(prefilter_case, n_shards):
    """The two-stage JL prefilter, as ``tests/test_prefilter.py`` holds
    the reference: one numpy projection injected into both packages; at
    one shard the port's answers equal the reference's; at every shard
    count the recall bounds of ``test_prefilter.py`` hold."""
    c = prefilter_case
    n = c["docs"].shape[0]
    n_pad = PD.shard_rows(n, n_shards) * n_shards
    bl = PD.build_local_buckets(
        np.pad(c["assign"], ((0, 0), (0, n_pad - n)), constant_values=-1),
        n_pad, n_shards, 40)
    shards = PD.shard_docs(torch.as_tensor(c["docs"]), n_shards)
    proj_shards = PD.shard_docs(torch.as_tensor(c["dp"]), n_shards)
    leaders = torch.as_tensor(_np(c["idx"].leaders))

    def port(shortlist=None):
        kw = {} if shortlist is None else dict(
            docs_proj=proj_shards, qw_proj=torch.as_tensor(c["qp"]),
            shortlist=shortlist)
        return PD.distributed_index_search(
            shards, leaders, bl, torch.as_tensor(c["qw"]),
            probes_t=(3, 3, 3), k=10, **kw)

    def recall(ids):
        return float(jnp.mean(R.competitive_recall(jnp.asarray(ids.numpy()),
                                                   c["gt_i"])))

    s1, i1 = port()
    s2, i2 = port(128)
    s3, i3 = port(250)
    r_exact, r_pref, r_more = recall(i1), recall(i2), recall(i3)
    assert r_pref >= r_exact - 2.0, (r_pref, r_exact)
    assert r_more >= r_pref - 0.3
    assert bool(torch.isfinite(s2[:, 0]).all())
    if n_shards == 1:
        mesh = jax.make_mesh((1,), ("data",))
        r_bl = jnp.asarray(RD.build_local_buckets(c["assign"], n, 1, 40))
        for shortlist, i_p in ((128, i2), (250, i3)):
            _, i_r = RD.distributed_index_search(
                mesh, jnp.asarray(c["docs"]), c["idx"].leaders, r_bl,
                jnp.asarray(c["qw"]), probes_t=(3, 3, 3), k=10,
                shard_axes=("data",), docs_proj=jnp.asarray(c["dp"]),
                qw_proj=jnp.asarray(c["qp"]), shortlist=shortlist)
            np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))


def test_make_projection_shape_and_seed():
    a = PD.make_projection(64, 16)
    b = PD.make_projection(64, 16, torch.Generator().manual_seed(42))
    assert tuple(a.shape) == (64, 16) and torch.equal(a, b)
    assert abs(float(a.std()) - 16 ** -0.5) < 0.05


def _assert_same(got, want, tag):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]),
                                  err_msg=f"{tag} ids")
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               atol=ATOL, err_msg=f"{tag} scores")
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]),
                                  err_msg=f"{tag} n_scored")


def _mutation_docs(spec, m, seed):
    x = np.random.default_rng(seed).normal(size=(m, 64)).astype(np.float32)
    return _np(R.normalize_fields(jnp.asarray(x), spec))


_ADDED, _GONE_OLD = 40, np.arange(0, 1000, 37)


def _engine_cases(spec, docs_rows):
    """The (tag, queries, search kwargs) the engine test runs: plain,
    exclude, rescore, batches of 1 / 3 / 7 and one 1-D query."""
    w = jnp.asarray([[0.7, 0.3]])
    cases = [("plain", None, dict(probes=PROBES, k=K)),
             ("exclude", None, dict(probes=PROBES, k=K, exclude=np.arange(
                 10, 15, dtype=np.int32))),
             ("rescore", None, dict(probes=PROBES, k=5, rescore=20))]
    for m in (1, 3, 7):
        qb = R.weighted_query(docs_rows[20:20 + m], jnp.tile(w, (m, 1)),
                              spec)
        cases.append((f"batch{m}", _np(qb), dict(probes=PROBES, k=K)))
    q1 = R.weighted_query(docs_rows[42], jnp.asarray([0.5, 0.5]), spec)
    cases.append(("1-D", _np(q1), dict(probes=PROBES, k=K)))
    return cases


def _run(engine, q, kw, to):
    kw = dict(kw)
    if "exclude" in kw:
        kw["exclude"] = to(kw["exclude"])
    return engine.search(to(q), **kw)


@pytest.fixture(scope="module")
def reference_answers(saved):
    """The JAX ``reference`` engine's answers to every engine case, on the
    saved index and after an add of 40 docs and a remove of old and new
    ones (computed once per corpus for every shard count)."""
    n, path, docs, qw = saved
    ref_idx = R.ClusterPruneIndex.load(path)
    spec = ref_idx.spec
    cases = _engine_cases(spec, ref_idx.docs)
    ref = R.get_engine(ref_idx, "reference")
    out = {tag: _run(ref, qw if q is None else q, kw, jnp.asarray)
           for tag, q, kw in cases}
    out["exact"] = ref.search_exact(jnp.asarray(qw), k=K)
    out["brute"] = R.brute_force_topk(jnp.asarray(docs), jnp.asarray(qw), K)
    new = _mutation_docs(spec, _ADDED, seed=7)
    ids_new = ref_idx.add_documents(jnp.asarray(new))
    out["after add"] = R.get_engine(ref_idx, "reference").search(
        jnp.asarray(qw), probes=PROBES, k=K)
    out["buckets after add"] = _np(ref_idx.buckets)
    gone = np.r_[_GONE_OLD, ids_new[::3]]
    out["removed"] = ref_idx.remove_documents(gone)
    ref = R.get_engine(ref_idx, "reference")
    out["after remove"] = ref.search(jnp.asarray(qw), probes=PROBES, k=K)
    out["rescore after"] = ref.search(jnp.asarray(qw), probes=PROBES, k=5,
                                      rescore=20)
    return cases, new, ids_new, gone, out


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_engine_matches_reference_engine(saved, reference_answers,
                                                 n_shards):
    """fp32 ShardedEngine at S shards against the JAX ``reference``
    engine: plain, exclude, rescore, batches of 1 / 3 / 7, one 1-D query,
    the exact tier, then the same engine object after an add and after a
    remove (it repacks on its next search)."""
    _, path, _, qw = saved
    cases, new, ids_new, gone, want = reference_answers
    index = _port(path)
    sh = P.get_engine(index, "sharded", n_shards=n_shards)
    assert sh.n_shards == n_shards and sh.devices == (torch.device("cpu"),)
    assert P.get_engine(index, "sharded", n_shards=n_shards) is sh
    for tag, q, kw in cases:
        got = _run(sh, qw if q is None else q, kw, torch.as_tensor)
        _assert_same(got, want[tag], tag)
        if tag == "1-D":
            assert tuple(got[0].shape) == (K,) and got[2].dim() == 0
    q = torch.as_tensor(qw)
    exact = sh.search_exact(q, k=K)
    _assert_same(exact, want["exact"], "exact tier")
    np.testing.assert_array_equal(exact[1].numpy(),
                                  np.asarray(want["brute"][1]))

    # mutations: the held engine repacks once on its next search
    data0 = sh._ensure_placed()[0]
    np.testing.assert_array_equal(index.add_documents(new), ids_new)
    np.testing.assert_array_equal(index.buckets.numpy(),
                                  want["buckets after add"])
    _assert_same(sh.search(q, probes=PROBES, k=K), want["after add"],
                 "after add")
    data1 = sh._ensure_placed()[0]
    assert data1 is not data0 and sh._ensure_placed()[0] is data1
    assert index.remove_documents(gone) == want["removed"]
    got = sh.search(q, probes=PROBES, k=K)
    _assert_same(got, want["after remove"], "after remove")
    assert not set(gone.tolist()) & set(got[1].reshape(-1).tolist())
    _assert_same(sh.search(q, probes=PROBES, k=5, rescore=20),
                 want["rescore after"], "rescore after")


def test_sharded_engine_clips_and_pads_k_past_every_candidate(saved):
    """A k past every slot the shards' schedules hold (8 shards, one
    probe): each shard's call clips to its ``k_pad``, the merge to
    ``S · cols``, and the engine pads back to k with -inf / -1; the live
    columns are the reference backend's answer."""
    _, path, _, qw = saved
    index = _port(path)
    eng = P.get_engine(index, "sharded", n_shards=8)
    b_l = int(index.ensure_local_bucket_major(8)[0].shape[2])
    k = 8 * b_l * 8 + 8                     # S x B_l x s_len (8), and more
    q = torch.as_tensor(qw[:1])
    got = eng.search(q, probes=1, k=k)
    want = P.get_engine(index, "reference").search(q, probes=1, k=k)
    m = want[0].shape[1]
    assert got[0].shape == (1, k) and m < k
    _assert_same([got[0][:, :m], got[1][:, :m], got[2]], want, "deep k")
    assert torch.isinf(got[0][:, m:]).all() and (got[1][:, m:] == -1).all()


_FORCED_8 = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core import ClusterPruneIndex, FieldSpec, normalize_fields, \
    weighted_query
from repro.core.engine import get_engine

assert jax.device_count() == 8
spec = FieldSpec(names=("a", "b"), dims=(32, 32))
docs = normalize_fields(jax.random.normal(jax.random.PRNGKey(0), (1019, 64)),
                        spec)
idx = ClusterPruneIndex.build(docs, spec, 16, n_clusterings=3, method="fpf",
                              key=jax.random.PRNGKey(0))
idx.save(sys.argv[1] + "_index.npz")
qw = weighted_query(docs[10:15], jnp.tile(jnp.asarray([[0.7, 0.3]]), (5, 1)),
                    spec)
out = {"qw": np.asarray(qw)}
for pd in ("bfloat16", "int8"):
    q_idx = dataclasses.replace(idx, bucket_data=None, bucket_scales=None,
                                pack_dtype=pd)
    eng = get_engine(q_idx, "sharded", interpret=True)
    assert eng.n_shards == 8
    for tag, res in (("plain", eng.search(qw, probes=6, k=10)),
                     ("rescore", eng.search(qw, probes=6, k=5, rescore=20)),
                     ("exact", eng.search_exact(qw, k=10))):
        for name, x in zip(("s", "i", "n"), res):
            out[f"{pd}_{tag}_{name}"] = np.asarray(x)
np.savez(sys.argv[1] + "_answers.npz", **out)
print("FORCED8_OK")
"""


def test_sharded_quantised_packs_match_reference_on_8_host_devices(
        tmp_path):
    """bf16 and int8 packs at S = 8: the reference's ShardedEngine on 8
    forced host devices (a subprocess, so the flag never reaches this
    process) against the port's at ``n_shards=8``, on the same saved
    index and queries. Tolerance 1e-5 on both packs: both sides multiply
    the same bf16-rounded query by the same bf16 / int8 values and scales
    exactly, so only the order of 64-term fp32 sums differs."""
    stem = str(tmp_path / "forced8")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _FORCED_8, stem], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "FORCED8_OK" in res.stdout, res.stdout + res.stderr
    want = np.load(stem + "_answers.npz")
    base = P.ClusterPruneIndex.load(stem + "_index.npz", device="cpu")
    q = torch.as_tensor(want["qw"])
    import dataclasses

    for pd in ("bfloat16", "int8"):
        index = dataclasses.replace(base, bucket_data=None,
                                    bucket_scales=None, pack_dtype=pd)
        eng = P.get_engine(index, "sharded", n_shards=8)
        for tag, got in (("plain", eng.search(q, probes=6, k=10)),
                         ("rescore", eng.search(q, probes=6, k=5,
                                                rescore=20)),
                         ("exact", eng.search_exact(q, k=10))):
            _assert_same(got, [want[f"{pd}_{tag}_{x}"] for x in "sin"],
                         f"{pd} {tag}")

"""PyTorch port, the GNN family: the five graph functions bit-identical to
the reference's; ``gcn_forward``, ``gcn_loss`` with its gradients,
``gcn_forward_layered`` / ``sampled_loss`` and ``graph_readout_loss``
against the reference on the reference's ``gcn_init`` weights (carried by
``from_reference_params``), padded edges included; the port's
``test_gcn_smoke`` and ``test_gcn_sampled_smoke``; the ``gcn-cora``
configs field for field.

Both sides run fp32 on the CPU. ``REL_TOL`` is 1e-5 of each tensor's
largest magnitude: an aggregated value sums ``deg + 1`` fp32 terms and a
layer's product 16 to 64 more, in another order on each side (the
reference's ``segment_sum`` and XLA's dot against ``index_add`` and
BLAS), a few ulps (the observed worst is 2.4e-7)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.data import graphs as RD  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro_torch.configs import get_arch as p_get_arch  # noqa: E402
from repro_torch.data import graphs as PD  # noqa: E402
from repro_torch.models import gnn as PG  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REL_TOL = 1e-5
CPU = "cpu"


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= REL_TOL, (what, err)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, (RD.GraphData, PD.GraphData)):
        for f in ("features", "edge_index", "labels", "graph_ids"):
            _equal(getattr(a, f), getattr(b, f))
        assert a.n_classes == b.n_classes
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _sampled(mod, g, seeds, fanouts, seed):
    ip, ix = mod.to_csr(g.edge_index, g.n_nodes)
    return (ip, ix), mod.sample_khop(ip, ix, seeds, fanouts,
                                     rng=np.random.default_rng(seed))


@pytest.mark.parametrize("name", ["cora_like", "power_law_graph",
                                  "molecule_batch", "to_csr", "sample_khop"])
def test_graph_functions_are_bit_identical(name):
    calls = {
        "cora_like": lambda m: m.cora_like(500, 4.0, 40, 5, seed=3),
        "power_law_graph": lambda m: m.power_law_graph(3000, 20_000, 12, 6,
                                                       seed=1),
        "molecule_batch": lambda m: m.molecule_batch(6, 12, 40, 8, 3,
                                                     seed=2),
        "to_csr": lambda m: m.to_csr(m.power_law_graph(
            800, 6000, 4, 3, seed=5).edge_index, 800),
        "sample_khop": lambda m: _sampled(
            m, m.power_law_graph(900, 9000, 4, 3, seed=7),
            np.arange(0, 900, 9), (6, 4), 11),
    }
    _equal(calls[name](PD), calls[name](RD))


def _pair(cfg_r, key=0):
    """(reference params, port params on the same values)."""
    params = RG.gcn_init(cfg_r, jax.random.PRNGKey(key))
    return params, PG.from_reference_params(
        PG.GCNConfig(**{f: getattr(cfg_r, f) for f in (
            "name", "n_layers", "d_in", "d_hidden", "n_classes",
            "aggregator", "norm", "readout")}),
        jax.tree.map(np.asarray, params), device=CPU)


def _padded(edge_index, n, rng):
    """The edge list with padded edges (src and/or dst = n) shuffled in."""
    pad = np.array([[n, n, 3, n], [n, 5, n, 0]], np.int32)
    e = np.concatenate([edge_index, pad], 1)
    return e[:, rng.permutation(e.shape[1])].astype(np.int32)


CORA = dict(n_layers=2, d_in=48, d_hidden=16, n_classes=7)


def test_gcn_forward_matches_reference():
    cfg = RG.GCNConfig(**CORA)
    g = RD.cora_like(300, 4.0, 48, 7, seed=1)
    e = _padded(g.edge_index, 300, np.random.default_rng(0))
    params, pp = _pair(cfg)
    want = RG.gcn_forward(params, jnp.asarray(g.features), jnp.asarray(e),
                          cfg)
    with torch.no_grad():
        got = PG.gcn_forward(pp, torch.as_tensor(g.features),
                             torch.as_tensor(e), PG.GCNConfig(**CORA))
    assert got.dtype == torch.float32 and got.shape == (300, 7)
    _close(got.numpy(), want, "logits")
    # padded edges add nothing: the same logits without them
    with torch.no_grad():
        bare = PG.gcn_forward(pp, torch.as_tensor(g.features),
                              torch.as_tensor(g.edge_index),
                              PG.GCNConfig(**CORA))
    _close(bare.numpy(), want, "logits without the padding")


def test_sym_coeffs_match_reference():
    e = _padded(RD.cora_like(200, 5.0, 8, 3, seed=4).edge_index, 200,
                np.random.default_rng(1))
    want = RG._sym_coeffs(jnp.asarray(e), 200)
    got = PG._sym_coeffs(torch.as_tensor(e), 200)
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w, what in zip(got[2:], want[2:], ("coeff", "self")):
        _close(g.numpy(), w, what)
    assert float(got[2][torch.as_tensor(e[0] == 200)].abs().max()) == 0.0


def test_gcn_loss_and_gradients_match_reference():
    cfg = RG.GCNConfig(**CORA)
    g = RD.cora_like(300, 4.0, 48, 7, seed=1)
    e = _padded(g.edge_index, 300, np.random.default_rng(2))
    mask = (np.arange(300) % 3 == 0).astype(np.float32)
    params, pp = _pair(cfg, key=1)
    loss_r, g_r = jax.value_and_grad(RG.gcn_loss)(
        params, jnp.asarray(g.features), jnp.asarray(e),
        jnp.asarray(g.labels), jnp.asarray(mask), cfg)
    loss_p = PG.gcn_loss(pp, torch.as_tensor(g.features), torch.as_tensor(e),
                         torch.as_tensor(g.labels), torch.as_tensor(mask),
                         PG.GCNConfig(**CORA))
    grads = torch.autograd.grad(loss_p, list(pp.values()))
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=REL_TOL)
    for (n, _), gr in zip(pp.items(), grads):
        _close(gr.numpy(), g_r[n], n)


def _local_subgraph(g, seeds, fanouts, seed, pad_rng=None):
    """sample_khop's layers re-indexed to the subgraph (seeds first),
    outermost hop first, optionally with padded edges."""
    (ip, ix), (layers, node_set) = _sampled(PD, g, seeds, fanouts, seed)
    nodes = np.concatenate([seeds, np.setdiff1d(node_set, seeds)])
    order = np.argsort(nodes)
    local = lambda v: order[np.searchsorted(nodes[order], v)]  # noqa: E731
    n = len(nodes)
    lists = []
    for src, dst in reversed(layers):
        e = np.stack([local(src), local(dst)]).astype(np.int32)
        lists.append(e if pad_rng is None else _padded(e, n, pad_rng))
    return g.features[nodes], lists, g.labels[seeds]


def test_layered_forward_and_sampled_loss_match_reference():
    cfg = RG.GCNConfig(n_layers=2, d_in=32, d_hidden=16, n_classes=5)
    pcfg = PG.GCNConfig(n_layers=2, d_in=32, d_hidden=16, n_classes=5)
    g = RD.cora_like(600, 5.0, 32, 5, seed=2)
    seeds = np.arange(0, 600, 10)
    feats, lists, labels = _local_subgraph(g, seeds, (5, 3), 0,
                                           np.random.default_rng(3))
    params, pp = _pair(cfg, key=2)
    want = RG.gcn_forward_layered(params, jnp.asarray(feats),
                                  [jnp.asarray(e) for e in lists], cfg)
    t_lists = [torch.as_tensor(e) for e in lists]
    with torch.no_grad():
        got = PG.gcn_forward_layered(pp, torch.as_tensor(feats), t_lists,
                                     pcfg)
    _close(got.numpy(), want, "layered logits")
    loss_r, g_r = jax.value_and_grad(RG.sampled_loss)(
        params, jnp.asarray(feats), [jnp.asarray(e) for e in lists],
        jnp.asarray(labels), len(seeds), cfg)
    loss_p = PG.sampled_loss(pp, torch.as_tensor(feats), t_lists,
                             torch.as_tensor(labels), len(seeds), pcfg)
    grads = torch.autograd.grad(loss_p, list(pp.values()))
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=REL_TOL)
    for (n, _), gr in zip(pp.items(), grads):
        _close(gr.numpy(), g_r[n], n)
    with pytest.raises(ValueError, match="edge lists"):
        PG.gcn_forward_layered(pp, torch.as_tensor(feats), t_lists[:1], pcfg)


def test_graph_readout_loss_matches_reference():
    mol = dict(n_layers=2, d_in=16, d_hidden=16, n_classes=2,
               readout="mean")
    cfg = RG.GCNConfig(**mol)
    m = RD.molecule_batch(8, 10, 28, 16, 2, seed=3)
    e = _padded(m.edge_index, m.n_nodes, np.random.default_rng(4))
    params, pp = _pair(cfg, key=3)
    loss_r, g_r = jax.value_and_grad(RG.graph_readout_loss)(
        params, jnp.asarray(m.features), jnp.asarray(e),
        jnp.asarray(m.graph_ids), jnp.asarray(m.labels), 8, cfg)
    loss_p = PG.graph_readout_loss(
        pp, torch.as_tensor(m.features), torch.as_tensor(e),
        torch.as_tensor(m.graph_ids), torch.as_tensor(m.labels), 8,
        PG.GCNConfig(**mol))
    grads = torch.autograd.grad(loss_p, list(pp.values()))
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=REL_TOL)
    for (n, _), gr in zip(pp.items(), grads):
        _close(gr.numpy(), g_r[n], n)


# ------------------------------------------- tests/test_models_smoke.py's
def test_gcn_smoke():
    cfg = p_get_arch("gcn-cora").make_smoke_config()
    g = PD.cora_like(400, 4.0, cfg.d_in, cfg.n_classes, seed=1)
    params = PG.gcn_init(cfg, torch.Generator().manual_seed(0), device=CPU)
    feats = torch.as_tensor(g.features)
    edges = torch.as_tensor(g.edge_index)
    with torch.no_grad():
        logits = PG.gcn_forward(params, feats, edges, cfg)
    assert logits.shape == (400, cfg.n_classes)
    assert bool(torch.all(torch.isfinite(logits)))
    # a few train steps reduce the loss
    opt = adamw(5e-2)
    state = opt.init(params)
    mask = torch.ones(400)
    labels = torch.as_tensor(g.labels)
    l0 = None
    for _ in range(12):
        loss = PG.gcn_loss(params, feats, edges, labels, mask, cfg)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        params, state = opt.update(grads, state, params)
        l0 = l0 or float(loss.detach())
    assert float(loss.detach()) < l0


def test_gcn_sampled_smoke():
    cfg = PG.GCNConfig(n_layers=2, d_in=32, d_hidden=16, n_classes=5)
    g = PD.cora_like(600, 5.0, 32, 5, seed=2)
    seeds = np.arange(64)
    feats, lists, _ = _local_subgraph(g, seeds, (5, 3), 0)
    params = PG.gcn_init(cfg, torch.Generator().manual_seed(0), device=CPU)
    with torch.no_grad():
        logits = PG.gcn_forward_layered(
            params, torch.as_tensor(feats),
            [torch.as_tensor(e) for e in lists], cfg)
    assert bool(torch.all(torch.isfinite(logits[:len(seeds)])))


# ----------------------------------------------------------------- configs
def test_gcn_cora_configs_match_reference():
    for make in ("make_config", "make_smoke_config"):
        r = getattr(r_get_arch("gcn-cora"), make)()
        p = getattr(p_get_arch("gcn-cora"), make)()
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert PG.gcn_param_specs(p) == {
            k: v.shape for k, v in RG.gcn_param_specs(r).items()}
        assert list(PG.gcn_param_specs(p)) == list(RG.gcn_param_specs(r))
    assert PG.GCNConfig.dtype == torch.float32       # a class attribute
    assert "dtype" not in {f.name for f in dataclasses.fields(PG.GCNConfig)}


def test_gcn_init_rule_and_reference_params_refusals():
    cfg = p_get_arch("gcn-cora").make_config()
    p = PG.gcn_init(cfg, torch.Generator().manual_seed(1), device=CPU)
    assert list(p) == ["w0", "w1", "b0", "b1"]
    assert all(t.requires_grad and t.dtype == torch.float32
               for t in p.values())
    p = {k: v.detach() for k, v in p.items()}
    assert float(p["b0"].abs().max()) == float(p["b1"].abs().max()) == 0.0
    for name, fan_in in (("w0", 1433), ("w1", 16)):
        std = float(p[name].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.1, (name, std)
    ref = {k: np.zeros(v, np.float32) for k, v in
           PG.gcn_param_specs(cfg).items()}
    with pytest.raises(KeyError, match="missing"):
        PG.from_reference_params(cfg, {k: v for k, v in ref.items()
                                       if k != "b1"}, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        PG.from_reference_params(cfg, dict(ref, w1=np.zeros((3, 3))),
                                 device=CPU)

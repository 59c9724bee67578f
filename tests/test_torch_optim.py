"""PyTorch port, the optimizers (``repro_torch.optim``) against the JAX
reference's (``repro.optim``) from the same numpy parameters and
gradients.

Both sides run fp32 on the CPU and update by the same formulas; the port
updates in place and takes the clip's norm from per-tensor norms, so the
two differ by a few fp32 roundings: parameters and states are held to
``OPT_TOL`` (1e-6 absolute on values of order 1) after every step.
Gradients are fed as numpy arrays, never recomputed, because AdamW's
first step is sign-like (``m_hat / sqrt(v_hat) = g / |g|``): gradients
that differ by fp32 noise near 0 would move a parameter by up to 2 lr in
opposite directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as R  # noqa: E402
from repro.optim.adafactor import FactoredSlot as RFactoredSlot  # noqa: E402
from repro_torch import optim as P  # noqa: E402
from repro_torch.optim.adafactor import FactoredSlot, FullSlot  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402

OPT_TOL = dict(rtol=0, atol=1e-6)
# (V, E) tables, an MLP weight above and below Adafactor's factoring
# threshold of 128, a bias, a scalar-like vector
SHAPES = {"table_0": (300, 16), "w_big": (256, 160), "w": (64, 32),
          "b": (32,), "s": (1,)}


def _params(seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=s).astype(np.float32) for n, s in
            shapes.items()}


def _grads(step, scale, shapes=SHAPES):
    rng = np.random.default_rng(100 + step)
    out = {n: (scale * rng.normal(size=s)).astype(np.float32)
           for n, s in shapes.items()}
    out["table_0"][rng.random(300) < 0.5] = 0.0      # rows the batch missed
    return out


def _port(tree, dtype=torch.float32):
    return {n: torch.tensor(np.asarray(v)).to(dtype) for n, v in tree.items()}


def _jax(tree, dtype=jnp.float32):
    return {n: jnp.asarray(v).astype(dtype) for n, v in tree.items()}


def _close(got: dict, want: dict, what: str, **tol):
    assert set(got) == set(want), what
    for n in want:
        np.testing.assert_allclose(
            got[n].float().numpy(), np.asarray(want[n], np.float32),
            err_msg=f"{what}[{n}]", **(tol or OPT_TOL))


def _run_both(make_r, make_p, grad_scale, steps=3, dtype="float32"):
    """``steps`` updates of both optimizers from the same parameters and
    gradients; yields (step, reference params, reference state, port
    params, port state) after each."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rp, pp = _jax(_params(), jd), _port(_params(), td)
    ropt, popt = make_r(), make_p()
    rs, ps = ropt.init(rp), popt.init(pp)
    for step in range(steps):
        g = _grads(step, grad_scale)
        rp, rs = ropt.update(_jax(g, jd), rs, rp)
        pp2, ps = popt.update(_port(g, td), ps, pp)
        assert pp2 is pp                        # updated in place
        yield step, rp, rs, pp, ps


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("clip,grad_scale", [
    (1.0, 1.0),          # |g| ~ 100: the clip is active
    (1e4, 1.0),          # computed, inactive (scale 1)
    (None, 1.0),         # no clip
    (1.0, 1e-4),         # |g| ~ 0.01 < 1: inactive
])
def test_adamw_matches_reference(clip, grad_scale):
    for step, rp, rs, pp, ps in _run_both(
            lambda: R.adamw(1e-2, grad_clip=clip),
            lambda: P.adamw(1e-2, grad_clip=clip), grad_scale):
        _close(pp, rp, f"params after step {step + 1}")
        _close(ps.mu, rs.mu, "mu")
        # nu ~ (1 - b2) g^2: relative to its own scale
        _close(ps.nu, rs.nu, "nu", rtol=1e-5, atol=1e-12)
        assert ps.step == int(rs.step) == step + 1


def test_adamw_bf16_params_round_like_reference():
    """bf16 parameters: fp32 arithmetic, one rounding to bf16 per step on
    both sides (round to nearest even), so they agree to one bf16 ulp."""
    for step, rp, rs, pp, ps in _run_both(
            lambda: R.adamw(1e-2), lambda: P.adamw(1e-2), 1.0,
            dtype="bfloat16"):
        assert all(p.dtype == torch.bfloat16 for p in pp.values())
        assert all(m.dtype == torch.float32 for m in ps.mu.values())
        _close(pp, rp, f"bf16 params after step {step + 1}",
               rtol=2.0 ** -8, atol=1e-6)


def test_adamw_global_norm_is_the_reference_clip_norm():
    g = _grads(0, 3.0)
    want = float(jnp.sqrt(sum(jnp.sum(jnp.square(jnp.asarray(v)))
                              for v in g.values())))
    got = float(global_norm(_port(g)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -------------------------------------------------------------- SGD
@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_sgd_matches_reference(nesterov, wd):
    for step, rp, rs, pp, ps in _run_both(
            lambda: R.sgd(1e-2, nesterov=nesterov, weight_decay=wd),
            lambda: P.sgd(1e-2, nesterov=nesterov, weight_decay=wd), 1.0):
        _close(pp, rp, f"params after step {step + 1}")
        _close(ps.momentum, rs.momentum, "momentum")


# ------------------------------------------------------------- Adafactor
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])
def test_adafactor_matches_reference(wd, grad_scale):
    for step, rp, rs, pp, ps in _run_both(
            lambda: R.adafactor(1e-2, weight_decay=wd),
            lambda: P.adafactor(1e-2, weight_decay=wd), grad_scale):
        _close(pp, rp, f"params after step {step + 1}")
        assert ps.step == int(rs.step) == step + 1
        for n, s in ps.slots.items():
            r = rs.slots[n]
            assert isinstance(s, FactoredSlot) == isinstance(r, RFactoredSlot)
            for a, b in zip(s, r):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=0)


def test_adafactor_state_is_factored():
    state = P.adafactor().init({"big": torch.zeros(256, 512),
                                "small": torch.zeros(8)})
    assert isinstance(state.slots["big"], FactoredSlot)
    assert state.slots["big"].vr.shape == (256,)
    assert state.slots["big"].vc.shape == (512,)
    assert isinstance(state.slots["small"], FullSlot)
    # the threshold is 128 on both of the last two axes, as the reference
    for shape in [(127, 512), (512, 127), (128, 128), (3, 128, 128)]:
        ref = R.adafactor().init({"x": jnp.zeros(shape)}).slots["x"]
        mine = P.adafactor().init({"x": torch.zeros(shape)}).slots["x"]
        assert type(mine).__name__ == type(ref).__name__, shape
        assert [tuple(t.shape) for t in mine] == [tuple(t.shape) for t in ref]


# ---------------------------------------------- descent and accumulation
def _quadratic_problem():
    """The reference's test problem, on numpy: ``mean((x w + b)^2)``."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 64)))
    params = {"w": np.ones((64, 32), np.float32),
              "b": np.zeros((32,), np.float32)}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return torch.mean(torch.square(pred)), {"pred": pred}

    return params, {"x": x}, loss_fn


def _leaf_params(params):
    return {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}


@pytest.mark.parametrize("make_opt", [
    lambda: P.adamw(1e-2), lambda: P.sgd(1e-2), lambda: P.adafactor(1e-2),
], ids=["adamw", "sgd", "adafactor"])
def test_optimizers_descend(make_opt):
    params, batch, loss_fn = _quadratic_problem()
    params, batch = _leaf_params(params), _port(batch)
    opt = make_opt()
    state = opt.init(params)
    l0 = float(loss_fn(params, batch)[0].detach())
    for _ in range(25):
        _, grads, _ = P.accumulate_gradients(loss_fn, params, batch, 1)
        params, state = opt.update(grads, state, params)
    assert float(loss_fn(params, batch)[0].detach()) < 0.5 * l0


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_grad_accum_matches_full_batch_and_reference(n_micro):
    params, batch, loss_fn = _quadratic_problem()
    tp, tb = _leaf_params(params), _port(batch)
    l1, g1, _ = P.accumulate_gradients(loss_fn, tp, tb, 1)
    ln, gn, aux = P.accumulate_gradients(loss_fn, tp, tb, n_micro)
    np.testing.assert_allclose(float(l1), float(ln), rtol=1e-5)
    for n in g1:
        np.testing.assert_allclose(g1[n].numpy(), gn[n].numpy(), atol=1e-5)
        assert gn[n].dtype == torch.float32 and not gn[n].requires_grad
    # aux of the last microbatch
    assert aux["pred"].shape == (16 // n_micro, 32)

    def r_loss(p, b):
        pred = b["x"] @ p["w"] + p["b"]
        return jnp.mean(jnp.square(pred)), {}

    rl, rg, _ = R.accumulate_gradients(r_loss, _jax(params), _jax(batch),
                                       n_micro)
    np.testing.assert_allclose(float(ln), float(rl), rtol=1e-6)
    for n in rg:
        np.testing.assert_allclose(gn[n].numpy(), np.asarray(rg[n]),
                                   rtol=1e-5, atol=1e-6)


def test_grad_accum_unused_parameter_gets_zeros_and_bad_split_raises():
    params, batch, loss_fn = _quadratic_problem()
    tp = _leaf_params(params) | {"unused": torch.ones(3, requires_grad=True)}
    _, grads, _ = P.accumulate_gradients(loss_fn, tp, _port(batch), 2)
    assert torch.equal(grads["unused"], torch.zeros(3))
    with pytest.raises(ValueError, match="divisible"):
        P.accumulate_gradients(loss_fn, tp, _port(batch), 3)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed", [0, 1, 7, 123, 999])
def test_int8_roundtrip_bounded_error(seed):
    g = {"a": np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                           (64, 64)))}
    q, s = P.int8_compress(_port(g))
    back = P.int8_decompress(q, s)
    err = float(torch.max(torch.abs(back["a"] - _port(g)["a"])))
    assert err <= float(s["a"]) * 0.5 + 1e-6      # half-step quantisation
    rq, rs = R.int8_compress(_jax(g))
    assert q["a"].dtype == torch.int8
    assert np.array_equal(q["a"].numpy(), np.asarray(rq["a"]))
    assert float(s["a"]) == float(rs["a"])


def test_int8_rounds_half_to_even_like_jnp_round():
    g = {"a": np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0], np.float32)}
    q, _ = P.int8_compress(_port(g))              # scale = 127 / 127 = 1
    rq, _ = R.int8_compress(_jax(g))
    assert q["a"].tolist() == np.asarray(rq["a"]).tolist() == [
        -2, -2, 0, 0, 2, 2, 127]


@pytest.mark.parametrize("k_frac", [0.1, 0.013])
def test_ef_topk_residual_conserves_signal(k_frac):
    g = {"a": np.arange(100.0, dtype=np.float32).reshape(10, 10),
         "ties": np.repeat(np.float32([1.0, -3.0, 2.0, -3.0]), 25)}
    res = {n: np.zeros_like(v) for n, v in g.items()}
    sparse, new_res = P.ef_topk_compress(_port(g), _port(res), k_frac=k_frac)
    for n in g:
        np.testing.assert_allclose((sparse[n] + new_res[n]).numpy(), g[n],
                                   atol=1e-6)
    # the largest entries were transmitted
    assert float(sparse["a"][9, 9]) == 99.0
    # ties at the threshold are all kept, whichever one topk picked
    assert int((sparse["ties"] != 0).sum()) == 50
    rs_, rr = R.ef_topk_compress(_jax(g), _jax(res), k_frac=k_frac)
    for n in g:
        assert np.array_equal(sparse[n].numpy(), np.asarray(rs_[n]))
        assert np.array_equal(new_res[n].numpy(), np.asarray(rr[n]))


# ------------------------------------------------------- state carry-over
@pytest.mark.parametrize("which", ["adamw", "sgd", "adafactor"])
def test_from_reference_state_continues_the_reference_trajectory(which):
    """Two reference steps, the state carried across, a third step on both
    sides from the same parameters and gradients."""
    make_r = {"adamw": R.adamw, "sgd": R.sgd, "adafactor": R.adafactor}[which]
    make_p = {"adamw": P.adamw, "sgd": P.sgd, "adafactor": P.adafactor}[which]
    ropt, popt = make_r(1e-2), make_p(1e-2)
    rp = _jax(_params())
    rs = ropt.init(rp)
    for step in range(2):
        rp, rs = ropt.update(_jax(_grads(step, 1.0)), rs, rp)
    pp = _port({n: np.asarray(v) for n, v in rp.items()})
    ps = P.from_reference_state(
        jax.tree.map(np.asarray, rs), popt.init(pp))
    rp, rs = ropt.update(_jax(_grads(2, 1.0)), rs, rp)
    pp, ps = popt.update(_port(_grads(2, 1.0)), ps, pp)
    _close(pp, rp, "params after the carried step")
    with pytest.raises(KeyError):
        P.from_reference_state(jax.tree.map(np.asarray, rs),
                               popt.init({"other": torch.zeros(3)}))

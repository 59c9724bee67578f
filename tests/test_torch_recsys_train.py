"""PyTorch port, recsys training: the gradients of the four losses (DLRM
one-hot through the gather and multi-hot through the differentiable
``embed_bag``), ``embed_bag``'s backward, BCE at a logit of exactly 0,
``recsys_train_step`` against the reference's ``jax.value_and_grad`` +
``adamw(1e-3)`` step, the model-flop count, and BST learning on the port.

Weights come from the reference's ``*_init`` (``from_reference_params``),
batches from the port's generators (bit-identical to the reference's,
``tests/test_torch_recsys.py``). Both sides run fp32 on the CPU, so
gradients differ in summation order only: each parameter's gradient is
held within ``GRAD_RTOL`` of that tensor's largest value (a probe of the
four smoke configs found at most 1.4e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.configs.common import _recsys_model_flops  # noqa: E402
from repro.models import embedding as r_emb  # noqa: E402
from repro.models import recsys as r_rs  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro_torch import configs as P_configs  # noqa: E402
from repro_torch.configs.common import (  # noqa: E402
    recsys_loss_and_grads, recsys_model_flops, recsys_serve_step,
    recsys_train_step)
from repro_torch.data import history_batch  # noqa: E402
from repro_torch.models import embedding as p_emb  # noqa: E402
from repro_torch.models import recsys as p_rs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_recsys import _batch, _pair, _to_jax, _to_torch  # noqa: E402

GRAD_RTOL = 1e-5
# embed_bag on a bf16 table: the port accumulates the table's gradient in
# fp32 and rounds once; the reference scatter-adds bf16 products in bf16
# (one rounding per duplicate id), so they may differ by a few bf16
# roundings of the largest value: 2**-6 relative to each tensor's max.
BF16_GRAD_RTOL = 2.0 ** -6
# Three AdamW(1e-3) steps from the same weights and batches. An update is
# lr * m_hat / (sqrt(v_hat) + eps), so gradients that differ in fp32
# summation order move it by far less than lr, except where |g| sits at
# fp32 noise: there the first, sign-like step may differ by up to 2 lr.
# These batches measured at most 7.7e-6 (AutoInt) after 3 steps; 0.1 lr
# holds that with a 13x margin and still catches a wrong step.
TRAJ_ATOL = 1e-4
R_LOSS = {"dlrm-mlperf": r_rs.dlrm_loss, "bst": r_rs.bst_loss,
          "autoint": r_rs.autoint_loss, "mind": r_rs.mind_loss}
CASES = [("dlrm-mlperf", 1), ("dlrm-mlperf", 3), ("bst", 1),
         ("autoint", 1), ("mind", 1)]


def _close_by_max(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.max(np.abs(want))) or 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


# ----------------------------------------------------- BCE at a logit of 0
def test_bce_gradient_at_zero_logit_matches_jax():
    """``jnp.maximum(x, 0)`` has gradient 0 at x = 0; ``torch.clamp(x,
    min=0)`` has 1 there, ``F.relu`` 0."""
    logits = np.zeros(3, np.float32)
    labels = np.array([0.0, 1.0, 0.0], np.float32)
    want = jax.grad(r_rs.bce_with_logits)(jnp.asarray(logits),
                                          jnp.asarray(labels))
    x = torch.tensor(logits, requires_grad=True)
    p_rs.bce_with_logits(x, torch.tensor(labels)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert x.grad[0] == x.grad[2] == 0.0           # torch.clamp gives 1/3
    np.testing.assert_allclose(x.grad.numpy() * 3, [0.0, -1.0, 0.0],
                               rtol=1e-6)
    # and away from 0 both follow sigmoid(x) - y
    z = np.array([-2.0, 0.5, 3.0], np.float32)
    want = jax.grad(r_rs.bce_with_logits)(jnp.asarray(z), jnp.asarray(labels))
    x = torch.tensor(z, requires_grad=True)
    p_rs.bce_with_logits(x, torch.tensor(labels)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)


# ------------------------------------------------------ embed_bag backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_gradients_match_jax(dtype, combiner, weighted):
    """Table and weight gradients against ``jax.grad`` of
    ``embed_bag_jax``: -1 padding (a bag of padding only among them),
    duplicate ids inside a bag and across bags, a cotangent from numpy."""
    rng = np.random.default_rng(5)
    v, e, b, l = 40, 8, 13, 6
    table = rng.normal(size=(v, e)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    idx[:, 1] = idx[:, 0]                          # duplicates in a bag
    idx[3] = 7                                     # one row six times
    idx[rng.random((b, l)) < 0.25] = -1
    idx[5] = -1                                    # an empty bag
    w = rng.uniform(0.5, 2.0, size=(b, l)).astype(np.float32)
    cot = rng.normal(size=(b, e)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def r_fn(t, ww):
        out = r_emb.embed_bag_jax(t, jnp.asarray(idx),
                                  ww if weighted else None,
                                  combiner=combiner)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want_t, want_w = jax.grad(r_fn, argnums=(0, 1))(
        jnp.asarray(table).astype(jd), jnp.asarray(w))
    t = torch.tensor(table).to(td).requires_grad_()
    ww = torch.tensor(w, requires_grad=True) if weighted else None
    out = p_emb.embed_bag(t, torch.tensor(idx), ww, combiner=combiner)
    assert out.grad_fn is not None and out.dtype == td
    (out.float() * torch.tensor(cot)).sum().backward()
    rtol = GRAD_RTOL if dtype == "float32" else BF16_GRAD_RTOL
    assert t.grad.dtype == td and t.grad.shape == (v, e)
    _close_by_max(t.grad.float().numpy(), np.asarray(want_t, np.float32),
                  rtol, "table grad")
    assert not t.grad[~np.isin(np.arange(v), idx)].any()  # untouched rows
    if weighted:
        assert ww.grad.dtype == torch.float32
        assert not ww.grad[torch.tensor(idx) < 0].any()   # padding: 0
        _close_by_max(ww.grad.numpy(), np.asarray(want_w), rtol,
                      "weights grad")


def test_embed_bag_weights_only_and_no_grad_paths():
    """A gradient for the weights alone (the table frozen), and no graph
    under no_grad / inference mode (the serving path)."""
    table = torch.randn(10, 4)
    idx = torch.tensor([[1, 2, -1], [3, 3, 0]])
    w = torch.tensor([[1.0, 2.0, 3.0], [0.5, 0.5, 1.0]], requires_grad=True)
    p_emb.embed_bag(table, idx, w).sum().backward()
    want = torch.stack([table[1].sum(), table[2].sum(), torch.tensor(0.0),
                        table[3].sum(), table[3].sum(), table[0].sum()])
    torch.testing.assert_close(w.grad.reshape(-1), want)
    t = table.clone().requires_grad_()
    with torch.no_grad():
        assert p_emb.embed_bag(t, idx).grad_fn is None
    with torch.inference_mode():
        assert p_emb.embed_bag(t, idx).grad_fn is None


# --------------------------------------------------- gradients of the losses
@pytest.mark.parametrize("arch,multi_hot", CASES)
def test_loss_gradients_match_jax_grad(arch, multi_hot):
    """Per-parameter gradients of the four losses at the smoke configs
    against ``jax.value_and_grad`` of the reference's, from the same
    weights and batch: DLRM one-hot (the gather) and multi-hot M = 3
    (``embed_bag``'s backward), BST and MIND on padded histories, MIND
    with the reference's routing logits."""
    rcfg, pcfg, params, model = _pair(arch)
    b = _batch(arch, pcfg, multi_hot=multi_hot)
    want_l, want_g = jax.value_and_grad(R_LOSS[arch])(params, _to_jax(b),
                                                      rcfg)
    loss, grads = recsys_loss_and_grads(model, _to_torch(b))
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and not g.requires_grad
        _close_by_max(g.numpy(), want_g[name], GRAD_RTOL, name)
    assert all(p.grad is None for p in model.p.values())


def test_dlrm_multi_hot_gradient_goes_through_embed_bag_backward(
        monkeypatch):
    """The multi-hot loss differentiates through ``_EmbedBag`` once per
    field (not through autograd of the plain version)."""
    _, pcfg, _, model = _pair("dlrm-mlperf")
    calls = []
    real = p_emb._EmbedBag.backward

    def counting(ctx, grad_out):
        calls.append(tuple(grad_out.shape))
        return real(ctx, grad_out)

    monkeypatch.setattr(p_emb._EmbedBag, "backward", staticmethod(counting))
    b = _to_torch(_batch("dlrm-mlperf", pcfg, multi_hot=3))
    recsys_loss_and_grads(model, b)
    assert calls == [(16, pcfg.embed_dim)] * pcfg.n_sparse


# -------------------------------------------------------------- the step
@pytest.mark.parametrize("arch,multi_hot", CASES)
def test_train_step_matches_reference_value_and_grad_adamw(arch, multi_hot):
    """Three steps of ``recsys_train_step`` with ``adamw(1e-3)`` against
    the reference's ``value_and_grad`` + ``adamw(1e-3).update`` (the body
    of ``recsys_train_cell``) on the same batches: losses step by step,
    parameters and moments after the third."""
    rcfg, pcfg, params, model = _pair(arch)
    ropt, popt = r_adamw(1e-3), adamw(1e-3)
    rstate, pstate = ropt.init(params), popt.init(dict(model.p))

    @jax.jit
    def r_step(p, s, batch):
        loss, g = jax.value_and_grad(R_LOSS[arch])(p, batch, rcfg)
        p, s = ropt.update(g, s, p)
        return p, s, loss

    for step in range(3):
        b = _batch(arch, pcfg, step=step, multi_hot=multi_hot)
        params, rstate, want = r_step(params, rstate, _to_jax(b))
        loss, pstate = recsys_train_step(model, popt, pstate, _to_torch(b))
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                                   err_msg=f"loss at step {step}")
    assert pstate.step == 3
    for name, p in model.p.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                                   rtol=0, atol=TRAJ_ATOL, err_msg=name)
        _close_by_max(pstate.mu[name].numpy(), rstate.mu[name], GRAD_RTOL,
                      name)


def test_train_step_runs_on_inference_inputs_and_refuses_inference_mode():
    """Batches made under inference mode (as ``recsys_serve_step``'s) are
    cloned into the graph; a step under inference mode raises."""
    _, pcfg, _, model = _pair("bst")
    opt = adamw(1e-3)
    state = opt.init(dict(model.p))
    with torch.inference_mode():
        b = _to_torch(_batch("bst", pcfg))
    before = model.p["blk0_wq"].detach().clone()
    loss, state = recsys_train_step(model, opt, state, b)
    assert np.isfinite(float(loss)) and state.step == 1
    assert not torch.equal(before, model.p["blk0_wq"])
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
        recsys_train_step(model, opt, state, b)
    with pytest.raises(TypeError, match="not a recsys model"):
        recsys_loss_and_grads(torch.nn.Linear(2, 2), b)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "bst", "autoint", "mind"])
@pytest.mark.parametrize("which", ["make_config", "make_smoke_config"])
def test_model_flops_match_reference(arch, which):
    rcfg = getattr(r_get_arch(arch), which)()
    pcfg = getattr(P_configs.get_arch(arch), which)()
    for batch, train in ((65_536, True), (512, False)):
        assert recsys_model_flops(pcfg, batch, train=train) == (
            _recsys_model_flops(rcfg, batch, train=train))


def test_recsys_training_learns():
    """The reference's ``test_recsys_training_learns`` on the port: BST
    learns the hidden cluster signal (the last ten losses beat the first
    ten by more than 0.02)."""
    cfg = p_rs.BSTConfig(n_items=1000, embed_dim=16, seq_len=10, n_blocks=1,
                         n_heads=4, mlp=(32,))
    model = p_rs.BST(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    opt = adamw(1e-2)
    state = opt.init(dict(model.p))
    losses = []
    for i in range(60):
        h, t, y = history_batch(cfg.n_items, 256, cfg.seq_len, step=i)
        loss, state = recsys_train_step(
            model, opt, state, {"hist": torch.as_tensor(h),
                                "target": torch.as_tensor(t),
                                "label": torch.as_tensor(y)})
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.02, losses[::10]
    # the trained model still serves
    assert recsys_serve_step(model, {"hist": torch.as_tensor(h),
                                     "target": torch.as_tensor(t)}).shape == (
        256,)

"""PyTorch port, the LM family end to end: the five LM configurations'
``make_smoke_config()`` with the reference's ``init_params(cfg,
PRNGKey(0))`` carried across by ``from_reference_params``, through
``forward``, ``loss_fn`` and its gradients, ``prefill`` and three
``decode_step``s, against the JAX reference on the same tokens (from
``lm_batch``, bit-identical in both packages, checked too). Also the full
configurations field for field with their parameter counts, ``TokenStream``
and ``from_reference_params``' refusals.

Both sides run fp32 on the CPU. The random-init residual stream grows
through the layers (the reference's fan-in rule draws ``wv`` and ``wo``
wide; see ``test_torch_transformer``), so values are held relative to
each tensor's largest magnitude:

* ``REL_TOL`` (logits, caches, aux): 3e-4 of the largest value; the
  observed worst is 5.5e-5 (mistral's smoke config, three layers; fp32
  sums in another order, BLAS kernels that may change with the thread
  count).
* ``GRAD_REL_TOL``: 2e-3 of each gradient's largest value; the observed
  worst is 1.6e-4. On mistral's smoke config (other tokens) the
  reference's own fp32 gradients sit 7.2e-4 from an fp64 run of the same
  function, the port's 1.7e-4, and the two 6.4e-4 apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.data import lm as r_lm  # noqa: E402
from repro.models import transformer as R  # noqa: E402
from repro_torch import configs as P_configs  # noqa: E402
from repro_torch.data import lm as p_lm  # noqa: E402
from repro_torch.models import transformer as P  # noqa: E402

LM_ARCHS = ("qwen3-8b", "qwen2-moe-a2.7b", "minitron-8b",
            "mistral-large-123b", "llama4-maverick-400b-a17b")
REL_TOL = 3e-4
GRAD_REL_TOL = 2e-3
BATCH, SEQ = 2, 37          # 37: a multiple of neither attention chunk (16)
CPU = "cpu"

_PAIRS: dict = {}


def _pair(arch):
    """(reference cfg, port cfg, reference params, port module, tokens,
    labels), built once per arch in this process."""
    if arch not in _PAIRS:
        rc = r_get_arch(arch).make_smoke_config()
        pc = P_configs.get_arch(arch).make_smoke_config()
        params = R.init_params(rc, jax.random.PRNGKey(0))
        model = P.from_reference_params(
            pc, jax.tree.map(np.asarray, params), device=CPU)
        toks, labels = p_lm.lm_batch(pc.vocab, BATCH, SEQ, step=3)
        labels = labels.copy()
        labels[:, -3:] = -1                      # masked positions
        _PAIRS[arch] = (rc, pc, params, model, toks, labels)
    return _PAIRS[arch]


def _close(got, want, rtol=REL_TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, (what, err, rtol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    rc, pc, params, model, toks, _ = _pair(arch)
    lr, ar = R.forward(params, jnp.asarray(toks), rc)
    with torch.no_grad():
        lp, ap = P.forward(model, torch.as_tensor(toks), pc)
    assert lp.dtype == torch.float32 and lp.shape == (BATCH, SEQ, pc.vocab)
    _close(lp.numpy(), lr, what="logits")
    np.testing.assert_allclose(float(ap), float(ar), rtol=REL_TOL, atol=0)
    assert (float(ar) > 0) == (pc.moe is not None)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` (labels -1 masked, + aux) and every parameter's gradient
    against ``jax.value_and_grad``; the port's blocks run under
    ``torch.utils.checkpoint`` (``remat``) while autograd records."""
    rc, pc, params, model, toks, labels = _pair(arch)
    (loss_r, m_r), g_r = jax.value_and_grad(
        lambda p: R.loss_fn(p, jnp.asarray(toks), jnp.asarray(labels), rc),
        has_aux=True)(params)
    loss_p, m_p = P.loss_fn(model, torch.as_tensor(toks),
                            torch.as_tensor(labels), pc)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_p, [p for _, p in
                                         model.named_parameters()])
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_p["nll"].detach()), float(m_r["nll"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_p["aux"].detach()), float(m_r["aux"]),
                               rtol=REL_TOL)
    want = P._flatten(jax.tree.map(np.asarray, g_r))
    assert set(want) == set(names)
    for n, g in zip(names, grads):
        _close(g.numpy(), want[n], GRAD_REL_TOL, what=n)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_three_decode_steps_match_reference(arch):
    """Last-position logits and the cache (true layer order, padded to
    ``max_seq_len``) after ``prefill``, then three greedy ``decode_step``s
    fed the reference's argmax."""
    rc, pc, params, model, toks, _ = _pair(arch)
    lr, cr = R.prefill(params, jnp.asarray(toks), rc)
    with torch.no_grad():
        lp, cp = P.prefill(model, torch.as_tensor(toks), pc)
    assert cp["k"].shape == (pc.n_layers, BATCH, pc.max_seq_len,
                             pc.n_kv_heads, pc.d_head)
    _close(lp.numpy(), lr, what="prefill logits")
    for key in ("k", "v"):
        _close(cp[key].numpy(), cr[key], what=f"prefill cache {key}")
    assert int(cp["length"]) == int(cr["length"]) == SEQ
    for step in range(3):
        nxt = np.argmax(np.asarray(lr), -1).astype(np.int32)
        lr, cr = R.decode_step(params, cr, jnp.asarray(nxt), rc)
        with torch.no_grad():
            lp, cp = P.decode_step(model, cp, torch.as_tensor(nxt), pc)
        _close(lp.numpy(), lr, what=f"decode {step} logits")
        for key in ("k", "v"):
            _close(cp[key].numpy(), cr[key], what=f"decode {step} {key}")
        assert int(cp["length"]) == int(cr["length"]) == SEQ + step + 1


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_forward_at_generous_capacity(arch):
    """The port's own decode against its full forward on the extended
    sequence, at ``capacity_factor=8.0`` (no capacity drops), as
    ``tests/test_models_smoke.py`` holds the reference."""
    _, pc, _, model, toks, _ = _pair(arch)
    if pc.moe is not None:
        pc = dataclasses.replace(
            pc, moe=dataclasses.replace(pc.moe, capacity_factor=8.0))
    t = torch.as_tensor(toks[:, :16])
    with torch.no_grad():
        logits, cache = P.prefill(model, t, pc)
        nxt = logits.argmax(-1).to(torch.int32)
        step, cache = P.decode_step(model, cache, nxt, pc)
        full, _ = P.forward(model, torch.cat([t, nxt[:, None]], 1), pc)
    assert int(cache["length"]) == 17
    _close(step.numpy(), full[:, -1].numpy(), what="decode vs forward")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_fields_and_counts_match_reference(arch):
    """``make_config()`` and ``make_smoke_config()`` field for field
    (``jnp.bfloat16`` is ``torch.bfloat16``), parameter names and shapes,
    and ``count_params`` / ``active_params`` at full size."""
    for make in ("make_config", "make_smoke_config"):
        rc = getattr(r_get_arch(arch), make)()
        pc = getattr(P_configs.get_arch(arch), make)()
        r_fields, p_fields = dataclasses.asdict(rc), dataclasses.asdict(pc)
        assert np.dtype(r_fields.pop("dtype")).name == str(
            p_fields.pop("dtype")).removeprefix("torch.")
        assert r_fields == p_fields
        specs = P._flatten(jax.tree.map(lambda s: s.shape, R.param_specs(rc),
                                        is_leaf=lambda s: hasattr(s, "shape")))
        assert P.param_specs(pc) == specs
        assert P.count_params(pc) == R.count_params(rc)
        assert P.active_params(pc) == R.active_params(rc)
    assert P_configs.get_arch(arch).ARCH_ID == arch


def test_served_configs_parameter_counts():
    """The two configurations the card serves at full width."""
    q3 = P_configs.get_arch("qwen3-8b").make_config()
    moe = P_configs.get_arch("qwen2-moe-a2.7b").make_config()
    assert P.count_params(q3) == 8_190_735_360
    assert P.count_params(moe) == 15_146_256_384
    assert P.active_params(moe) == 2_378_008_576
    assert q3.dtype == moe.dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, batch=4, seq_len=32, step=7, shard=2, n_shards=4),
    dict(vocab=151_936, batch=2, seq_len=64, step=0),
    dict(vocab=353, batch=3, seq_len=17, step=5, seed=9),
])
def test_lm_batch_bit_identical(kw):
    kw = dict(kw)
    args = (kw.pop("vocab"), kw.pop("batch"), kw.pop("seq_len"))
    rt, rl = r_lm.lm_batch(*args, **kw)
    pt, pl = p_lm.lm_batch(*args, **kw)
    assert pt.dtype == rt.dtype and pl.dtype == rl.dtype
    assert np.array_equal(pt, rt) and np.array_equal(pl, rl)
    assert np.array_equal(pt[:, 1:], pl[:, :-1])          # shifted labels


def test_token_stream_matches_reference_and_resumes():
    r = r_lm.TokenStream(vocab=500, batch=2, seq_len=8, seed=4, shard=1,
                         n_shards=2)
    p = p_lm.TokenStream(vocab=500, batch=2, seq_len=8, seed=4, shard=1,
                         n_shards=2)
    for _ in range(3):
        a, b = next(r), next(p)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert p.state_dict() == r.state_dict() == {"step": 3}
    q = p_lm.TokenStream(vocab=500, batch=2, seq_len=8, seed=4, shard=1,
                         n_shards=2)
    q.load_state_dict(p.state_dict())
    assert np.array_equal(next(q)[0], next(r)[0])


def test_from_reference_params_refuses_wrong_names_and_shapes():
    rc, pc, params, _, _, _ = _pair("qwen3-8b")
    flat = P._flatten(jax.tree.map(np.asarray, params))
    missing = {k: v for k, v in flat.items() if k != "layers.sub0.q_norm"}
    with pytest.raises(KeyError, match="q_norm"):
        P.from_reference_params(pc, missing, device=CPU)
    extra = dict(flat, **{"layers.sub0.bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="bias"):
        P.from_reference_params(pc, extra, device=CPU)
    wrong = dict(flat, embed=np.zeros((3, pc.d_model), np.float32))
    with pytest.raises(ValueError, match="embed"):
        P.from_reference_params(pc, wrong, device=CPU)
    # the flattened form and the nested tree give the same module
    a = P.from_reference_params(pc, flat, device=CPU)
    b = P.from_reference_params(pc, jax.tree.map(np.asarray, params),
                                device=CPU)
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_from_reference_params_reads_bf16_leaves_bit_for_bit():
    """bf16 leaves arrive as ``ml_dtypes`` arrays; they are read through a
    uint16 view, so every bit survives."""
    rc = dataclasses.replace(r_get_arch("qwen2-moe-a2.7b").make_smoke_config(),
                             dtype=jnp.bfloat16)
    pc = dataclasses.replace(
        P_configs.get_arch("qwen2-moe-a2.7b").make_smoke_config(),
        dtype=torch.bfloat16)
    flat = P._flatten(jax.tree.map(
        np.asarray, R.init_params(rc, jax.random.PRNGKey(2))))
    model = P.from_reference_params(pc, flat, device=CPU)
    for n, t in model.named_parameters():
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.detach().view(torch.int16).numpy(),
                              flat[n].view(np.int16)), n


def test_every_entry_point_defaults_to_the_card():
    """Without ``device=`` the module and the cache go to the card, which
    this machine lacks: they raise rather than run on the CPU."""
    pc = P_configs.get_arch("qwen3-8b").make_smoke_config()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (lambda: P.Transformer(pc), lambda: P.init_params(pc),
                 lambda: P.init_cache(pc, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""PyTorch port, the LM training driver: ``train_lm`` resumes its own
checkpoints (``tests/test_substrate.py::test_train_driver_resume``,
ported), resumes the reference's and the reference resumes the port's;
SIGTERM checkpoints and exits through the CLI; the ``train_lm`` example at
a tiny size.

Across packages both sides run fp32 on the CPU from the same checkpoint
and the same batches (``lm_batch`` is bit-identical). The losses of the
resumed steps are held to ``rtol=1e-5`` and the final parameters to
``atol=1e-5``: fp32 sums in another order move a loss by a few ulps and
a gradient element by ~1e-7 of its scale; AdamW divides the first moment
by the root of the second, so an update moves by that relative error
times ``lr = 3e-4`` a step (the observed worst is 1.2e-7, in the
RMS-norm scales), while a wrong leaf, step count or batch moves the
parameters by ``lr`` or more.
"""

import os
import shutil
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.launch.train import train_lm as r_train_lm  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch as p_get_arch  # noqa: E402
from repro_torch.examples import train_lm as example  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-moe-a2.7b"
RUN = dict(batch=2, seq_len=16, ckpt_every=3, log_every=100)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def test_train_driver_resume(tmp_path):
    """Kill-and-restart: the driver resumes from the latest checkpoint."""
    cfg = p_get_arch(ARCH).make_smoke_config()
    ck = str(tmp_path / "run")
    _, losses1 = p_train.train_lm(cfg, steps=6, batch=2, seq_len=16,
                                  ckpt_dir=ck, ckpt_every=3, log_every=100,
                                  device="cpu")
    assert len(losses1) == 6
    # "crash" happened; rerun to 10 steps — must resume from step 6
    _, losses2 = p_train.train_lm(cfg, steps=10, batch=2, seq_len=16,
                                  ckpt_dir=ck, ckpt_every=3, log_every=100,
                                  device="cpu")
    assert len(losses2) == 4              # only steps 6..9 run


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's 3-step run and its own resume to step 6, a copy of
    its step-3 checkpoint, and the port's 3-step run with a copy."""
    d = tmp_path_factory.mktemp("cross")
    rc = r_get_arch(ARCH).make_smoke_config()
    pc = p_get_arch(ARCH).make_smoke_config()
    r_train_lm(rc, steps=3, ckpt_dir=str(d / "ref"), **RUN)
    shutil.copytree(d / "ref", d / "ref_copy")
    r_params, r_losses = r_train_lm(rc, steps=6, ckpt_dir=str(d / "ref"),
                                    **RUN)
    p_train.train_lm(pc, steps=3, ckpt_dir=str(d / "port"), device="cpu",
                     **RUN)
    shutil.copytree(d / "port", d / "port_copy")
    return {"dir": d, "rc": rc, "pc": pc,
            "ref_resumed": (PT._flatten(jax.tree.map(np.asarray, r_params)),
                            r_losses)}


def _assert_same_run(got_params: dict, got_losses, want_params: dict,
                     want_losses):
    assert len(got_losses) == len(want_losses) == 3     # steps 3, 4, 5
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL,
                               atol=0)
    assert set(got_params) == set(want_params)
    for n, v in want_params.items():
        np.testing.assert_allclose(got_params[n], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


def test_port_resumes_the_references_checkpoint(reference_runs):
    r = reference_runs
    model, losses = p_train.train_lm(
        r["pc"], steps=6, ckpt_dir=str(r["dir"] / "ref_copy"), device="cpu",
        **RUN)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _assert_same_run(got, losses, *r["ref_resumed"])


def test_reference_resumes_the_ports_checkpoint(reference_runs):
    r = reference_runs
    model, p_losses = p_train.train_lm(
        r["pc"], steps=6, ckpt_dir=str(r["dir"] / "port"), device="cpu",
        **RUN)
    r_params, r_losses = r_train_lm(
        r["rc"], steps=6, ckpt_dir=str(r["dir"] / "port_copy"), **RUN)
    got = PT._flatten(jax.tree.map(np.asarray, r_params))
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _assert_same_run(got, r_losses, want, p_losses)


def test_sigterm_checkpoints_and_the_driver_resumes(tmp_path):
    """``python -m repro_torch.launch.train`` in a subprocess gets SIGTERM
    after its first logged step: it checkpoints at the end of the step in
    progress, names that step and exits 0; an in-process resume starts
    there. (``signal.signal`` works only in a main thread and replaces the
    test runner's own handlers, so the hook runs in a subprocess.)"""
    ck = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-8b", "--smoke", "--device", "cpu", "--steps", "100000",
         "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
         "--ckpt-every", "100000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        first = proc.stdout.readline()
        assert first.startswith("[train] step 0 loss"), (
            first, proc.stderr.read() if proc.poll() is not None else "")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    lines = [ln for ln in out.splitlines() if "preempted" in ln]
    assert len(lines) == 1, out
    at = int(lines[0].split("checkpointed at ")[1].split(",")[0])
    assert at >= 1
    assert CheckpointManager(ck).steps() == [at]
    assert "[train] done." in out
    cfg = p_get_arch("qwen3-8b").make_smoke_config()
    _, losses = p_train.train_lm(cfg, steps=at + 2, batch=2, seq_len=16,
                                 ckpt_dir=ck, ckpt_every=100000,
                                 device="cpu")
    assert len(losses) == 2


def test_train_lm_example_at_a_tiny_size(tmp_path, capsys):
    """The example's run (its assertion included) on a 2-layer model, and
    its checkpoint directory resumed; the default is the reference's ~100M
    qwen3-style config."""
    c = example.CONFIG
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_head,
            c.d_ff, c.vocab, c.qk_norm, c.attn_q_chunk, c.attn_kv_chunk,
            c.max_seq_len, c.dtype) == (8, 512, 8, 4, 64, 2048, 32_000,
                                        True, 128, 128, 512, torch.float32)
    assert PT.count_params(c) == 64_235_008
    tiny = p_get_arch("qwen3-8b").make_smoke_config()
    ck = str(tmp_path / "ex")
    _, losses = example.run(tiny, steps=12, batch=4, seq_len=32,
                            ckpt_dir=ck, ckpt_every=6, lr=1e-2, device="cpu")
    assert len(losses) == 12
    assert "over 12 steps" in capsys.readouterr().out
    assert CheckpointManager(ck).steps() == [6, 12]
    _, more = p_train.train_lm(tiny, steps=16, batch=4, seq_len=32,
                               ckpt_dir=ck, ckpt_every=6, lr=1e-2,
                               device="cpu")
    assert len(more) == 4
    assert "resumed from step 12" in capsys.readouterr().out


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--steps", "1"])
    with pytest.raises(SystemExit, match="not an LM arch"):
        p_train.main(["--arch", "gcn-cora", "--device", "cpu"])

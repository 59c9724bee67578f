"""The port's dry-run held to the reference's compile: each cell's
``collective_bytes_per_chip`` on the single pod (16 x 16) against
``repro.launch.dryrun.run_cell``'s (one reference process for the module:
one JAX start, the cells compiled on 512 forced host devices), and each
counted cell's ``hlo_flops_per_chip`` and ``hlo_bytes_per_chip`` (the
port's model of XLA:CPU's cost analysis) against the reference's. A cell
without a caveat must come within +-20 % (or both be 0); a cell with one
must be outside, by the ratio its caveat names. The lookups the recsys
cells now route through a row-sharded program stay the parent's code on
plain tensors."""

from __future__ import annotations

import functools
import io
import json
import os
import re
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import embedding as E  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = ["dlrm-mlperf/serve_p99", "dlrm-mlperf/train_batch",
         "autoint/serve_bulk", "mind/serve_bulk", "gcn-cora/minibatch_lg",
         "gcn-cora/molecule", "bst/retrieval_cand",
         "qwen3-8b/decode_32k", "qwen3-8b/long_500k",
         "qwen2-moe-a2.7b/decode_32k", "qwen2-moe-a2.7b/train_4k",
         "paper-retrieval/serve_brute"]

# argv: out dir, cell names; the dry-run module sets XLA_FLAGS (512 host
# devices) before JAX starts
_REFERENCE = textwrap.dedent("""
    import repro.launch.dryrun as D
    import sys

    from repro.configs import all_cells

    want = set(sys.argv[2:])
    for cell in all_cells():
        if cell.name in want:
            D.run_cell(cell, "single", sys.argv[1])
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(out), *CELLS],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def _cell(name):
    arch, shape = name.split("/")
    return next(c for c in get_arch(arch).cells() if c.shape == shape)


@functools.lru_cache(maxsize=None)
def _port(name) -> dict:
    with redirect_stdout(io.StringIO()):
        return dryrun.run_cell(_cell(name), "single", None)


def _reference(reference, name) -> dict:
    with open(reference / f"{name.replace('/', '__')}__single.json") as f:
        return json.load(f)


def _named_ratio(caveat: str) -> float:
    """The ratio a caveat names: "... x<ratio> ..."."""
    return float(re.search(r"x(\d+(?:\.\d+)?)", caveat).group(1))


@pytest.mark.parametrize("name", CELLS)
def test_collective_bytes_match_the_reference_compile(reference, name):
    port, ref = _port(name), _reference(reference, name)
    a = ref["collective_bytes_per_chip"]
    b = port["collective_bytes_per_chip"]
    caveat = port["collective_caveat"]
    assert port["collective_comparable"] == (not caveat)
    if not caveat:
        assert (b == a == 0) or b == pytest.approx(a, rel=0.20), (a, b)
        assert port["replicated_ops"] == [], port["replicated_ops"]
        return
    # the caveat names this mesh's ratio
    assert b / a == pytest.approx(_named_ratio(caveat), rel=0.01), (
        b / a, caveat)


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if _cell(n).analytic is None])
@pytest.mark.parametrize("key", ["flops", "bytes"])
def test_flops_and_bytes_match_the_reference_cost_analysis(reference, name,
                                                           key):
    """The counted cells' flops and bytes accessed per chip, as the port's
    model of XLA:CPU's cost analysis charges its step, against the
    reference's ``cost_analysis()``."""
    port, ref = _port(name), _reference(reference, name)
    a, b = ref[f"hlo_{key}_per_chip"], port[f"hlo_{key}_per_chip"]
    assert port[f"counted_{key}_per_chip"] == b
    caveat = port.get(f"{key}_caveat", "")
    if not caveat:
        assert b == pytest.approx(a, rel=0.20), (a, b)
    else:
        assert b / a == pytest.approx(_named_ratio(caveat), rel=0.01), (
            b / a, caveat)


def test_plain_lookups_are_the_parents_code_bit_for_bit():
    """On plain CPU tensors ``lookup``, ``gather_rows`` and ``embed_bag``
    compute what the parent's code computed (``table[ids]`` per field,
    stacked; the autograd ``embed_bag``), outputs and gradients equal."""
    g = torch.Generator().manual_seed(3)
    tables = {f"table_{i}": torch.randn((50 + i, 8), generator=g)
              for i in range(3)}
    ids = torch.randint(0, 50, (16, 3), generator=g, dtype=torch.int32)
    w = torch.randn((16, 1, 8), generator=g)          # per row and column

    def run(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tables.items()}
        out = fn(leaves)
        (out * w).sum().backward()
        return out.detach(), {k: v.grad for k, v in leaves.items()}

    got = run(lambda t: E.lookup(t, ids))
    want = run(lambda t: torch.stack([t[f"table_{i}"][ids[:, i].long()]
                                      for i in range(3)], dim=1))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in tables)
    hist = torch.randint(0, 50, (16, 5), generator=g)
    got = run(lambda t: E.gather_rows(t["table_0"], hist))
    want = run(lambda t: t["table_0"][hist.long()])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["table_0"], want[1]["table_0"])
    bags = torch.randint(-1, 50, (16, 5), generator=g)
    for combiner in ("sum", "mean"):
        t1 = tables["table_1"].clone().requires_grad_(True)
        t2 = tables["table_1"].clone().requires_grad_(True)
        a = E.embed_bag(t1, bags, combiner=combiner)
        b = E._EmbedBag.apply(t2, bags, None, combiner)
        (a * w[:, 0]).sum().backward()
        (b * w[:, 0]).sum().backward()
        assert torch.equal(a, b) and torch.equal(t1.grad, t2.grad)

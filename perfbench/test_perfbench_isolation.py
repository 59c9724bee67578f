"""The harness, and the program modules it drives, load neither JAX nor
the JAX package (top-level module names compared whole: ``repro_torch`` is
not ``repro``), and the plain reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_harness_and_reference_load_no_jax_module():
    code = (
        "import sys, json\n"
        "import perfbench.harness, perfbench.trace, perfbench.datagen\n"
        "import perfbench.roofline\n"
        "import perfbench.reference.index_ref\n"
        "import perfbench.reference.search_ref\n"
        "import perfbench.systems.cluster_prune\n"
        "import perfbench.systems.paper_rank\n"
        "import repro_torch.core.index, repro_torch.core.weights\n"
        "import repro_torch.configs.paper_retrieval, repro_torch.kernels\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [harness.ROOT, os.path.join(harness.ROOT, "src")])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=harness.ROOT, timeout=120)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "repro_torch" in top          # the program, told apart whole


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & (FORBIDDEN | {"repro_torch"}), (name, tops)


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(harness.HERE):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, name))}
                assert not tops & FORBIDDEN, (name, tops & FORBIDDEN)

#!/usr/bin/env python3
"""Times variants of the ``topk_score`` CUDA kernel in turns on one card, to
show where its time goes::

    python3 scripts/topk_score_variants.py

Each variant is ``src/repro_torch/kernels/csrc/topk_score.cu`` with one text
substitution, built with the port's own ``nvcc`` flags into the git-ignored
``kernels/_build/variants/`` and called through the port's wrapper:

* ``kernel``: the source as it is;
* ``stage128``: 128-byte (32-column) shared-memory stages instead of 256;
* ``merge_in_smem``: every list merged by the shared ``warp_merge`` (lists
  shifted in shared memory), the merge of the first design;
* ``no_merge``: the merge skipped (the answers are wrong; scoring alone).

At ``chip_smoke.py``'s shape (64 x 100,000 x 2048 fp32 unit rows, k = 11,
per-query exclude) it prints, per variant, the time of each turn (kernel
order forwards, then backwards) and the error against the plain version,
then ``torch.topk(q @ docs.T)`` in the same process, as one JSON line with
the card's name and power limit. Needs a CUDA card and ``nvcc``.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import topk_score, topk_score_ref  # noqa: E402
from repro_torch.kernels.topk_score import ops  # noqa: E402

CSRC = os.path.join(os.path.dirname(common.__file__), "csrc")
OUT = os.path.join(os.path.dirname(common.__file__), "_build", "variants")
MERGE = "      if (k_list <= 32)\n"
VARIANTS = {
    "kernel": [],
    "stage128": [("constexpr int kSB = 256;", "constexpr int kSB = 128;")],
    "merge_in_smem": [(MERGE, "      if (false)\n")],
    "no_merge": [(MERGE, "      continue;\n      if (k_list <= 32)\n")],
}
STAGE_BYTES = {"stage128": 128}


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC, "topk_score.cu")) as f:
        text = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"topk_score_{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT, f"libtopk_score_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-I", CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


_build = common.build_cuda_library


def use(lib: str, name: str) -> None:
    """Route the wrapper to ``lib`` (its shared-memory mirror too)."""
    common.build_cuda_library = (
        lambda n: lib if n == "topk_score" else _build(n))
    common.load_cuda_library.cache_clear()
    common.cuda_function.cache_clear()
    sb = STAGE_BYTES.get(name, 256)
    ops._STAGE = ops._RB * (sb + 16) + ops._QT * (sb // 4) * 4


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    dev = common.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build()
    g = torch.Generator(device=dev).manual_seed(0)
    docs = torch.nn.functional.normalize(
        torch.randn(100_000, 2048, device=dev, generator=g), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn(64, 2048, device=dev, generator=g), dim=1)
    ex = torch.randint(0, 100_000, (64,), device=dev, dtype=torch.int32,
                       generator=g)
    want = topk_score_ref(q, docs, k=11, exclude=ex)
    out = {"card": card}
    for name in list(libs) + list(reversed(libs)):
        use(libs[name], name)
        got = topk_score(q, docs, k=11, exclude=ex)
        row = out.setdefault(name, {"ms": []})
        row["max_abs_err"] = float((got[0] - want[0]).abs().max())
        row["ids_equal"] = bool(torch.equal(got[1], want[1]))
        row["ms"].append(ms(lambda: topk_score(q, docs, k=11, exclude=ex),
                            20))
    out["torch.topk(q @ docs.T)"] = ms(lambda: torch.topk(q @ docs.T, 11), 20)
    print("[topk_score_variants] " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

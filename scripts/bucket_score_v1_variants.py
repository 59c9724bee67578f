#!/usr/bin/env python3
"""Times variants of the ``bucket_score`` (v1) CUDA kernel in turns on one
card, to show what its design choices are worth::

    python3 scripts/bucket_score_v1_variants.py

Each variant is ``src/repro_torch/kernels/csrc/bucket_score.cu`` with a few
text substitutions, built with the port's own ``nvcc`` flags into the
git-ignored ``kernels/_build/variants/`` and called through the port's
wrapper:

* ``kernel``: the source as it is (groups of at most 16 entries; lists of
  up to 32 entries merged in registers, one entry a lane);
* ``merge_in_smem``: every list merged in shared memory by the shared
  ``warp_merge``, as the tiled kernel's merge does;
* ``group8`` / ``group32``: groups of at most 8 / 32 (query, probe)
  entries of one bucket.

Inputs, on ``chip_smoke.py``'s 100,000-document index (D = 2048, K = 316,
T = 3, fp32 pack unless named): ``smoke`` — the flat probes of its 64
weighted queries at probes 12, on the fp32, bf16 and int8 packs; ``shared``
— every query probes the first query's 12 buckets (64 entries a bucket,
where the group size matters); ``bench`` — the kernels bench's 8 queries x
6 random probes over 64 x 128 x 1024. Per variant and input it prints the
time of each turn (variant order forwards, then backwards), the largest
score error against the plain version and whether the ids equal its ids;
then, for the source as it is on ``smoke[float32]``, the device time of
each kernel one call launches (``torch.profiler`` over 10 calls: the
inversion's sort and copies, the group kernel, the scoring and merge
launches). One JSON line with the card's name and power limit. Needs a
CUDA card and ``nvcc``.
"""

import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Retriever, get_engine, weighted_query  # noqa: E402
from repro_torch.data import CorpusConfig, make_corpus  # noqa: E402
from repro_torch.kernels import bucket_score, bucket_score_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

CSRC = os.path.join(os.path.dirname(common.__file__), "csrc")
OUT = os.path.join(os.path.dirname(common.__file__), "_build", "variants")
GROUP = "constexpr int kG = 16;"
WIDEST = "  else V1_SCORE(16);\n"
VARIANTS = {
    "kernel": [],
    "merge_in_smem": [("slot_merge::launch<true>(",
                        "slot_merge::launch<false>(")],
    "group8": [(GROUP, "constexpr int kG = 8;"),
               (WIDEST, "  else V1_SCORE(8);\n")],
    "group32": [(GROUP, "constexpr int kG = 32;"),
                (WIDEST, "  else if (g <= 16) V1_SCORE(16);\n"
                         "  else V1_SCORE(32);\n")],
}


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC, "bucket_score.cu")) as f:
        text = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"bucket_score_{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT, f"libbucket_score_{name}.so")
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


def use(lib: str) -> None:
    """Route the wrapper to ``lib``."""
    common.build_cuda_library = (
        lambda n: lib if n == "bucket_score" else _build(n))
    common.load_cuda_library.cache_clear()
    common.cuda_function.cache_clear()


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


def inputs(dev) -> dict:
    """``{input name: (queries, data, ids, probes, exclude)}``."""
    docs, spec, _ = make_corpus(CorpusConfig(n_docs=100_000, seed=0))
    index = Retriever.build(
        docs, spec, 316, n_clusterings=3, method="auto", device=dev,
        generator=torch.Generator().manual_seed(0), backend="fused").index
    rng = np.random.default_rng(0)
    qids = rng.choice(100_000, 64, replace=False)
    w = rng.dirichlet([1.0] * spec.s, size=64).astype(np.float32)
    qw = weighted_query(index.docs[torch.as_tensor(qids, device=dev)],
                        torch.as_tensor(w), spec)
    excl = torch.as_tensor(qids, dtype=torch.int32, device=dev)
    eng = get_engine(index, "fused")
    flat = eng._flat_probes(qw, eng._probes_t(12))
    out = {}
    for pd in ("float32", "bfloat16", "int8"):
        idx = index if pd == "float32" else dataclasses.replace(
            index, bucket_data=None, bucket_scales=None, pack_dtype=pd)
        data, ids, _ = idx.ensure_bucket_major()
        out[f"smoke[{pd}]"] = (qw, data, ids, flat, excl)
    data, ids, _ = index.ensure_bucket_major()
    out["shared"] = (qw, data, ids, flat[:1].expand(64, -1).contiguous(),
                     excl)
    rng = np.random.default_rng(0)
    bd = torch.as_tensor(rng.normal(size=(64, 128, 1024)).astype(np.float32),
                         device=dev)
    bi = torch.arange(64 * 128, dtype=torch.int32, device=dev).reshape(64, 128)
    qs = torch.as_tensor(rng.normal(size=(8, 1024)).astype(np.float32),
                         device=dev)
    pr = torch.as_tensor(rng.integers(0, 64, size=(8, 6)).astype(np.int32),
                         device=dev)
    out["bench"] = (qs, bd, bi, pr, None)
    return out


def device_ms(a) -> dict:
    """Device ms per call of each kernel a ``bucket_score`` call launches,
    by kernel name, from ``torch.profiler`` over 10 calls."""
    from torch.profiler import ProfilerActivity, profile

    bucket_score(*a[:4], k=10, exclude=a[4])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            bucket_score(*a[:4], k=10, exclude=a[4])
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:72]] = us / 1e3 / 10
    return out


def main():
    dev = common.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build()
    cases = inputs(dev)
    want = {name: bucket_score_ref(*a[:4], k=10, exclude=a[4])
            for name, a in cases.items()}
    out = {"card": card}
    for name in list(libs) + list(reversed(libs)):
        use(libs[name])
        row = out.setdefault(name, {})
        for case, a in cases.items():
            got = bucket_score(*a[:4], k=10, exclude=a[4])
            fin = torch.isfinite(want[case][0])
            cell = row.setdefault(case, {"ms": []})
            cell["max_abs_err"] = float(
                (got[0] - want[case][0])[fin].abs().max())
            cell["ids_equal"] = bool(torch.equal(got[1], want[case][1]))
            cell["ms"].append(ms(
                lambda: bucket_score(*a[:4], k=10, exclude=a[4]), 20))
    use(libs["kernel"])
    out["device ms per call, kernel, smoke[float32]"] = device_ms(
        cases["smoke[float32]"])
    print("[bucket_score_v1_variants] " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

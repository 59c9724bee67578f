#!/usr/bin/env python3
"""Times variants of the ``topk_score`` CUDA kernel in turns on one card, to
show where its time goes::

    python3 scripts/topk_score_variants.py

Each variant is ``src/repro_torch/kernels/csrc/topk_score.cu`` (with its
tensor-core core ``topk_score_tc.cuh``) under text substitutions, built with
the port's own ``nvcc`` flags into the git-ignored
``kernels/_build/variants/<name>/`` and called through the port's wrapper.
The script exits if a substitution no longer matches the source.

The CUDA-core core, at ``chip_smoke.py`` path B's shape (64 x 100,000 x
2048 fp32 unit rows, k = 11, per-query exclude):

* ``kernel``: the source as it is;
* ``stage128``: 128-byte (32-column) shared-memory stages instead of 256;
* ``merge_in_smem``: every list merged by the shared ``warp_merge`` (lists
  shifted in shared memory), the merge of the first design;
* ``no_merge``: the merge skipped (the answers are wrong; scoring alone).

The tensor-core core, at path M2's shape (256 x 390,624 x 4096 bf16 unit
rows, ``round_bf16``, k = 10, per-query exclude), beside the CUDA-core core
forced on the same inputs (``fma``):

* ``tc``: the source as it is;
* ``tc_cluster1``: no clusters: each CTA loads its own whole query stage
  (twice the L2 reads of the query block);
* ``tc_stages4``: a ring of four stages instead of three (fewer candidate
  and staging slots: at k = 10 too few to seed the first tile);
* ``tc_no_hint``: the loads without their L2 policies (evict first for
  the docs, evict last for the queries);
* ``tc_no_merge``: the epilogue skipped (the answers are wrong; the
  mainloop alone: TMA, wgmma and the stage ring);
* ``tc_probe``: the source with ``clock64`` probes in its consumers (CTA
  by CTA: cycles in all, waiting for a full stage, in the epilogue (the
  first tile's seeding included) and in the first tile's epilogue), read
  back after its last call.

Per variant it prints the time of each turn (variant order forwards, then
backwards) and the error against the plain version, then the library's
composite ``torch.topk(q @ docs.T)`` in the same process and, at M2's
shape without ``round_bf16``, the relative error of the tensor-core core's
and the plain version's fp32 sums against fp64 sums of the same rows, as
one JSON line with the card's name and power limit. Needs a CUDA card and
``nvcc``.
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
CU, TC = "topk_score.cu", "topk_score_tc.cuh"
EPILOGUES = [(TC, "        if (round_bf16)\n          tc_epilogue<true>(",
              "        if (false)\n          tc_epilogue<true>("),
             (TC, "        else\n          tc_epilogue<false>(",
              "        else if (false)\n          tc_epilogue<false>(")]
VARIANTS = {  # name: (shape, core, [(file, old, new), ...])
    "kernel": ("fp32", None, []),
    "stage128": ("fp32", None, [(CU, "constexpr int kSB = 256;",
                                 "constexpr int kSB = 128;")]),
    "merge_in_smem": ("fp32", None, [(CU, MERGE, "      if (false)\n")]),
    "no_merge": ("fp32", None, [
        (CU, MERGE, "      continue;\n      if (k_list <= 32)\n")]),
    "tc": ("bf16", "tc", []),
    "fma": ("bf16", "fma", []),
    "tc_cluster1": ("bf16", "tc", [(TC, "constexpr int kCluster = 2;",
                                    "constexpr int kCluster = 1;")]),
    "tc_stages4": ("bf16", "tc", [(TC, "constexpr int kStages = 3;",
                                   "constexpr int kStages = 4;")]),
    "tc_no_hint": ("bf16", "tc", [
        (TC, "kDocsHint = 0x12F0000000000000ull;",
         "kDocsHint = 0x1000000000000000ull;"),
        (TC, "kQueriesHint = 0x14F0000000000000ull;",
         "kQueriesHint = 0x1000000000000000ull;")]),
    "tc_no_merge": ("bf16", "tc", EPILOGUES),
    "tc_probe": ("bf16", "tc", [
        (TC, "namespace topk_tc {\n",
         "namespace topk_tc {\n"
         "__device__ unsigned long long g_probe[4096];\n"),
        (TC, "    float acc[128];\n",
         "    float acc[128];\n    unsigned long long p_[5] = {0, 0, 0, 0, 0};"
         "\n    const long long t0_ = clock64();\n"),
        (TC, "          mbar_wait(smem_u32(full + stage), phase);\n",
         "          const long long w_ = clock64();\n"
         "          mbar_wait(smem_u32(full + stage), phase);\n"
         "          p_[1] += clock64() - w_;\n"),
        (TC, "        if (u == u0 && ",
         "        const long long e_ = clock64();\n        if (u == u0 && "),
        (TC, " cap, ps);\n      }\n",
         " cap, ps);\n        p_[2] += clock64() - e_;\n"
         "        if (++p_[4] == 1) p_[3] = p_[2];\n      }\n"),
        (TC, "        part_i[out0 + i] = li[i * kBN + ct];\n      }\n    }\n",
         "        part_i[out0 + i] = li[i * kBN + ct];\n      }\n    }\n"
         "    p_[0] = clock64() - t0_;\n    if (ct == 0 && blockIdx.x < 819)\n"
         "      for (int i = 0; i < 5; ++i)\n"
         "        g_probe[5 * blockIdx.x + i] = p_[i];\n"),
        (CU, '}  // extern "C"\n',
         'int topk_score_probe_read(unsigned long long* out) {\n'
         '  return (int)cudaMemcpyFromSymbol(out, topk_tc::g_probe,\n'
         '                                   sizeof(topk_tc::g_probe));\n}\n\n'
         '}  // extern "C"\n')]),
}
PROBE_FIELDS = ("cycles", "full_wait_cycles", "epilogue_cycles",
                "first_tile_epilogue_cycles", "tiles")
STAGE_BYTES = {"stage128": 128}
CLUSTER = {"tc_cluster1": 1}


def build() -> dict:
    texts = {}
    for f in (CU, TC):
        with open(os.path.join(CSRC, f)) as fh:
            texts[f] = fh.read()
    procs = {}
    for name, (_, _, subs) in VARIANTS.items():
        src = dict(texts)
        for f, old, new in subs:
            if old not in src[f]:
                raise SystemExit(f"variant {name}: {old!r} not in {f}")
            src[f] = src[f].replace(old, new)
        out = os.path.join(OUT, name)
        os.makedirs(out, exist_ok=True)
        for f, text in src.items():
            with open(os.path.join(out, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(out, "libtopk_score.so")
        procs[name] = (lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-I", CSRC, "-o", lib,
             os.path.join(out, CU)],
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
    """Route the wrapper to ``lib`` (its shared-memory mirror and cluster
    size too)."""
    common.build_cuda_library = (
        lambda n: lib if n == "topk_score" else _build(n))
    common.load_cuda_library.cache_clear()
    common.cuda_function.cache_clear()
    sb = STAGE_BYTES.get(name, 256)
    ops._STAGE = ops._RB * (sb + 16) + ops._QT * (sb // 4) * 4
    ops._TC_CLUSTER = CLUSTER.get(name, 2)
    ops._tc_ctas.clear()


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


def read_probe(ctas: int) -> dict:
    """The ``tc_probe`` variant's counters of its last call, CTA by CTA:
    their mean, and the epilogue's cycles a tile past the first."""
    import ctypes

    import numpy as np

    buf = np.zeros(4096, np.uint64)
    fn = common.load_cuda_library("topk_score").topk_score_probe_read
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    if fn(buf.ctypes.data) != 0:
        raise SystemExit("tc_probe: reading the counters failed")
    p = buf[:5 * ctas].reshape(ctas, 5).astype(np.float64)
    out = {f: float(p[:, i].mean()) for i, f in enumerate(PROBE_FIELDS)}
    out["epilogue_cycles_a_later_tile"] = float(np.mean(
        (p[:, 2] - p[:, 3]) / np.maximum(p[:, 4] - 1, 1)))
    return out


def unit_rows(n, d, g, dtype):
    """``(n, d)`` unit rows, made 65,536 at a time."""
    x = torch.empty((n, d), dtype=dtype, device=g.device)
    for lo in range(0, n, 65536):
        hi = min(n, lo + 65536)
        x[lo:hi] = torch.nn.functional.normalize(
            torch.randn(hi - lo, d, device=g.device, generator=g), dim=1)
    return x


def main():
    dev = common.resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build()
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {"fp32": (unit_rows(100_000, 2048, g, torch.float32), 64, 11,
                      False),
             "bf16": (unit_rows(390_624, 4096, g, torch.bfloat16), 256, 10,
                      True)}
    inputs = {}
    for shape, (docs, nq, k, rnd) in cases.items():
        src = torch.randperm(docs.shape[0], device=dev, generator=g)[:nq]
        q = docs[src].contiguous()
        ex = src.to(torch.int32)
        inputs[shape] = (q, docs, k, ex, rnd, topk_score_ref(
            q, docs, k=k, exclude=ex, round_bf16=rnd))
    out = {"card": card}
    for name in list(libs) + list(reversed(libs)):
        shape, core, _ = VARIANTS[name]
        q, docs, k, ex, rnd, want = inputs[shape]
        use(libs[name], name)

        def call():
            return topk_score(q, docs, k=k, exclude=ex, round_bf16=rnd,
                              core=core)

        got = call()
        row = out.setdefault(name, {"shape": shape, "ms": []})
        row["max_abs_err"] = float((got[0] - want[0]).abs().max())
        row["ids_equal"] = bool(torch.equal(got[1], want[1]))
        if core == "tc":  # the CTAs the card holds at once (the grid's cap)
            row["co_resident_ctas"] = sorted(set(ops._tc_ctas.values()))
        if name == "tc_probe":
            row.setdefault("probe", []).append(
                read_probe(row["co_resident_ctas"][0]))
        row["ms"].append(ms(call, 20 if shape == "fp32" or core == "tc"
                            else 3))
    for shape, (q, docs, k, _, _, _) in inputs.items():
        out[f"torch.topk(q @ docs.T) {shape}"] = ms(
            lambda: torch.topk((q @ docs.T).float(), k), 20)
    # the fp32 sums behind the bf16 scores (round_bf16 off), held to fp64
    # sums of the same rows: relative error, largest and mean (signed)
    q, docs, k, ex, _, _ = inputs["bf16"]
    use(libs["tc"], "tc")
    for name, fn in (("tc", lambda: topk_score(q, docs, k=k, exclude=ex,
                                               core="tc")),
                     ("plain", lambda: topk_score_ref(q, docs, k=k,
                                                      exclude=ex))):
        s, i = fn()
        exact = torch.einsum("qkd,qd->qk", docs[i.long()].double(),
                             q.double())
        rel = (s.double() - exact) / exact.abs()
        out[f"{name} fp32 sum rel err"] = {"max": float(rel.abs().max()),
                                           "mean": float(rel.mean())}
    print("[topk_score_variants] " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

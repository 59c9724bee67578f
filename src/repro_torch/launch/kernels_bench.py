"""Kernel bench of the port: each hand-written kernel against its plain
PyTorch version at the reference bench's shapes, then every engine backend
on one built index (port of ``benchmarks/kernels_bench.py``)::

    PYTHONPATH=src python -m repro_torch.launch.kernels_bench [--device cpu]

On the card each row times the kernel with CUDA events and holds it
against its plain version on the same inputs; with ``--device cpu`` the
wrappers run their plain versions, so agreement is trivial there and the
times are host times of PyTorch's CPU kernels, not device times. The rows
go to stdout as CSV and, as one JSON object, to
``src/repro_torch/kernels/_build/kernels_bench.json`` (git-ignored); this
never writes the reference's ``BENCH_*.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import kernels as K
from ..core import (ClusterPruneIndex, FieldSpec, available_backends,
                    get_engine, normalize_fields)
from ..kernels.common import resolve_device

__all__ = ["run", "run_engines", "main"]

_OUT = os.path.join(os.path.dirname(K.__file__), "_build",
                    "kernels_bench.json")


def _timer(dev: torch.device):
    """``ms(fn, reps)``: mean time of one call — CUDA events on the card,
    the host clock on the CPU."""

    def ms(fn, reps: int = 10) -> float:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize(dev)
            return a.elapsed_time(b) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    return ms


def _max_err(a, b) -> float:
    a, b = a.float(), b.float()
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def run(device=None) -> list[dict]:
    """The five kernels at ``benchmarks/kernels_bench.py``'s shapes."""
    dev = resolve_device(device)
    ms = _timer(dev)
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(x, device=dev)

    rows = []

    def row(name, shape, kernel, plain, atol, ids_equal=None):
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = _max_err(got[0], want[0])
        ok = err <= atol and (ids_equal is None
                              or torch.equal(got[1], want[1]))
        rows.append({"kernel": name, "shape": shape, "device": str(dev),
                     "agrees": bool(ok), "max_abs_err": err,
                     "atol": atol, "ms": ms(kernel), "plain_ms": ms(plain, 3)})

    # topk_score: serving-scale brute scoring
    q = t(rng.normal(size=(64, 1024)).astype(np.float32))
    d = t(rng.normal(size=(16384, 1024)).astype(np.float32))
    row("topk_score", "64x16384x1024 k=10",
        lambda: K.topk_score(q, d, k=10),
        lambda: K.topk_score_ref(q, d, k=10), 1e-3, ids_equal=True)

    # bucket_score (v1) and bucket_score_tiled: the cluster-prune inner loop
    nb, b, dim, p = 64, 128, 1024, 6
    bd = t(rng.normal(size=(nb, b, dim)).astype(np.float32))
    bi = t(np.arange(nb * b, dtype=np.int32).reshape(nb, b))
    qs = t(rng.normal(size=(8, dim)).astype(np.float32))
    probes_np = rng.integers(0, nb, size=(8, p)).astype(np.int32)
    probes = t(probes_np)
    row("bucket_score", f"{nb}x{b}x{dim} P={p}",
        lambda: K.bucket_score(qs, bd, bi, probes, k=10),
        lambda: K.bucket_score_ref(qs, bd, bi, probes, k=10), 1e-3,
        ids_equal=True)
    qt = K.pick_query_tile(dim, b, k_pad=16)
    sched, member = (t(x) for x in K.build_probe_schedule(probes_np, qt))
    row("bucket_score_tiled", f"{nb}x{b}x{dim} P={p} QT={qt}",
        lambda: K.bucket_score_tiled(qs, bd, bi, sched, member, k=10),
        lambda: K.bucket_score_tiled_ref(qs, bd, bi, sched, member, k=10),
        1e-3, ids_equal=True)
    bd8, sc8 = K.quantize_bucket_major(bd)
    row("bucket_score_tiled[int8]", f"{nb}x{b}x{dim} P={p} QT={qt}",
        lambda: K.bucket_score_tiled(qs, bd8, bi, sched, member, k=10,
                                     scales=sc8),
        lambda: K.bucket_score_tiled_ref(qs, bd8, bi, sched, member, k=10,
                                         scales=sc8), 1e-3)

    # fpf_iter: one preprocessing round
    x = torch.nn.functional.normalize(
        t(rng.normal(size=(16384, 512)).astype(np.float32)), dim=1)
    ms0 = torch.full((16384,), float("-inf"), device=dev)
    cur = torch.tensor(0, dtype=torch.int32, device=dev)
    row("fpf_iter", "16384x512", lambda: K.fpf_iter(x, cur, ms0),
        lambda: K.fpf_iter_ref(x, cur, ms0), 1e-5, ids_equal=True)

    # embed_bag: the recsys lookup
    tbl = t(rng.normal(size=(100_000, 128)).astype(np.float32))
    idx = t(rng.integers(-1, 100_000, size=(256, 16)).astype(np.int32))
    row("embed_bag", "100000x128 B=256 L=16",
        lambda: K.embed_bag(tbl, idx, combiner="sum"),
        lambda: K.embed_bag_ref(tbl, idx, combiner="sum"), 1e-4)

    print(f"\n# Kernels vs their plain versions (device={dev})")
    print("kernel,shape,agrees,max_abs_err,ms,plain_ms")
    for r in rows:
        print(f"{r['kernel']},({r['shape']}),{r['agrees']},"
              f"{r['max_abs_err']:.3g},{r['ms']:.4f},{r['plain_ms']:.4f}")
    return rows


def run_engines(device=None) -> list[dict]:
    """Every engine backend on ONE built index (n=4096, K=64, T=3), 16
    queries at probes=9: time per query and agreement with ``reference``."""
    dev = resolve_device(device)
    ms = _timer(dev)
    rng = np.random.default_rng(1)
    spec = FieldSpec(names=("a", "b", "c"), dims=(64, 64, 128))
    docs = normalize_fields(torch.as_tensor(
        rng.normal(size=(4096, 256)).astype(np.float32)), spec)
    idx = ClusterPruneIndex.build(docs, spec, 64, n_clusterings=3,
                                  pack_major=True, device=dev,
                                  generator=torch.Generator().manual_seed(1))
    qw = idx.docs[:16]
    ex = torch.arange(16, dtype=torch.int32, device=dev)
    ref = get_engine(idx, "reference").search(qw, probes=9, k=10, exclude=ex)
    print(f"\n# Engine backends — one index (n=4096, K=64, T=3), 16 queries,"
          f" probes=9 (device={dev})")
    print("backend,ms_per_query,matches_reference,n_scored_mean")
    rows = []
    for name in available_backends():
        eng = get_engine(idx, name)
        s, i, ns = eng.search(qw, probes=9, k=10, exclude=ex)
        match = bool(torch.equal(i, ref[1]) and torch.equal(ns, ref[2])
                     and torch.allclose(s, ref[0], atol=1e-4))
        t_ms = ms(lambda e=eng: e.search(qw, probes=9, k=10, exclude=ex))
        rows.append({"backend": name, "device": str(dev),
                     "ms_per_query": t_ms / 16, "matches_reference": match,
                     "n_scored_mean": float(ns.float().mean())})
        print(f"{name},{t_ms / 16:.3f},{match},{float(ns.float().mean()):.0f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": str(dev),
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else None,
           "kernels": run(dev), "engines": run_engines(dev)}
    os.makedirs(os.path.dirname(_OUT), exist_ok=True)
    with open(_OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n[kernels_bench] wrote {_OUT}")
    bad = [r["kernel"] for r in out["kernels"] if not r["agrees"]]
    bad += [r["backend"] for r in out["engines"] if not r["matches_reference"]]
    if bad:
        raise SystemExit(f"[kernels_bench] disagreement: {bad}")


if __name__ == "__main__":
    main()

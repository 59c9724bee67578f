"""Shared harness of the port's paper experiments (port of
``benchmarks/common.py``): corpus sizes, the paper's weight sets, a timer
that synchronises the card, and the JSON each experiment writes.

Each experiment writes one JSON object (``--out``; by default
``src/repro_torch/benchmarks/_results/<experiment>_<scale>.json``, git
ignored, never the reference's ``BENCH_*.json``) that carries the device,
the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, and the
versions of torch and CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..data import CorpusConfig, make_corpus

__all__ = ["bench_sizes", "PAPER_WEIGHT_SETS", "std_parser", "sync",
           "timed_all", "spread", "make_bench_corpus", "card_line",
           "run_info", "write_json", "make_fp32_pack"]

_RESULTS = os.path.join(os.path.dirname(__file__), "_results")


def bench_sizes(scale: str) -> dict:
    """Corpus sizing: ``quick``, the paper's ``ts1`` / ``ts2`` (the
    reference's shapes), and ``tiny``, a few hundred documents for the CPU
    tests. Topic-mixture hardness puts ground-truth neighbours across
    cluster boundaries (the paper's mid-recall regime)."""
    common = {"n_topics": 200, "topic_mix_alpha": 1.0,
              "noise_terms": (4, 2, 24)}
    if scale == "tiny":
        return {"n_docs": 600, "n_queries": 16, "k_clusters": 12,
                "field_dims": (32, 32, 64),
                "vocab_sizes": (400, 600, 1500), **common}
    if scale == "quick":
        return {"n_docs": 12_000, "n_queries": 100, "k_clusters": 110,
                "field_dims": (256, 256, 512),
                "vocab_sizes": (4000, 6000, 15000), **common}
    if scale == "ts1":
        return {"n_docs": 53_722, "n_queries": 250, "k_clusters": 500,
                "field_dims": (1024, 1024, 2048),
                "vocab_sizes": (8000, 12000, 30000), **common}
    if scale == "ts2":
        return {"n_docs": 100_000, "n_queries": 250, "k_clusters": 1000,
                "field_dims": (1024, 1024, 2048),
                "vocab_sizes": (8000, 12000, 30000), **common}
    raise ValueError(scale)


# The paper's 7 weight sets (Table 2) — title/authors/abstract.
PAPER_WEIGHT_SETS = (
    ("equal", (1 / 3, 1 / 3, 1 / 3)),
    ("0.4-0.4-0.2", (0.4, 0.4, 0.2)),
    ("0.2-0.4-0.4", (0.2, 0.4, 0.4)),
    ("0.4-0.2-0.4", (0.4, 0.2, 0.4)),
    ("0.2-0.6-0.2", (0.2, 0.6, 0.2)),
    ("0.6-0.2-0.2", (0.6, 0.2, 0.2)),
    ("0.2-0.2-0.6", (0.2, 0.2, 0.6)),
)


def std_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--scale", default="quick",
                    choices=["tiny", "quick", "ts1", "ts2"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="JSON path (default: benchmarks/_results/"
                         "<experiment>_<scale>.json in the package)")
    return ap


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_all(fn, dev: torch.device, *, repeats: int = 3, warmup: int = 1):
    """Per-repeat host wall times of ``fn()`` (s), the card synchronised
    before the clock starts and after ``fn`` returns."""
    for _ in range(warmup):
        fn()
    ts = []
    out = None
    for _ in range(repeats):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return ts, out


def spread(ts) -> dict:
    """The median, least and largest of per-repeat times, and the times
    themselves, in the unit they were given."""
    return {"median": float(np.median(ts)), "min": float(min(ts)),
            "max": float(max(ts)), "samples": [float(t) for t in ts]}


def make_bench_corpus(sz: dict, seed: int, dev: torch.device):
    """The experiment's corpus (made on the host, moved to ``dev``):
    ``(docs (n, D) fp32, spec)``."""
    docs_np, spec, _ = make_corpus(CorpusConfig(
        n_docs=sz["n_docs"], field_dims=sz["field_dims"],
        vocab_sizes=sz["vocab_sizes"], n_topics=sz["n_topics"],
        topic_mix_alpha=sz["topic_mix_alpha"],
        noise_terms=sz["noise_terms"], seed=seed,
    ))
    return torch.as_tensor(docs_np, device=dev), spec


def card_line(dev: torch.device) -> str | None:
    """The card's name and power limit from nvidia-smi (None on the
    CPU)."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[dev.index or 0] if out else ""


def run_info(experiment: str, scale: str, seed: int, dev: torch.device
             ) -> dict:
    return {"experiment": experiment, "scale": scale, "seed": seed,
            "sizes": bench_sizes(scale), "device": str(dev),
            "card": card_line(dev), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def write_json(payload: dict, out: str | None) -> str:
    path = out or os.path.join(
        _RESULTS, f"{payload['experiment']}_{payload['scale']}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"# wrote {path}")
    return path


def make_fp32_pack(index) -> int:
    """Make ``index``'s bucket-major pack (the fused backend's layout) in
    fp32 and return its bytes. No experiment cuts it to a narrower dtype:
    a pack that does not fit on the card ends the run with its byte
    count."""
    need = index.buckets.numel() * index.docs.shape[1] * 4
    try:
        index.ensure_bucket_major()
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(f"the fp32 bucket-major pack needs {need} bytes "
                           f"({tuple(index.buckets.shape)} ids x D = "
                           f"{index.docs.shape[1]}): it does not fit on "
                           f"{index.docs.device}") from e
    return need

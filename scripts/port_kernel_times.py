#!/usr/bin/env python3
"""Times the PyTorch/CUDA port's kernels at ``chip_smoke.py``'s shapes, from
the source tree given on the command line, so that two trees (a parent
commit unpacked with ``git archive`` and the working tree, say) can be
compared in turns on one card::

    python3 scripts/port_kernel_times.py <tree root> <label>

On the 100,000-document index of ``chip_smoke.py`` (D = 2048, K = 316,
T = 3) and its 64 weighted more-like-this queries it times, back to back
with CUDA events: ``bucket_score_tiled`` on the fp32, bf16 and int8 packs
at probes 12 and on the exact tier, ``topk_score`` (64 x 100k x 2048,
k = 11), ``bucket_score`` v1 (64 queries x 12 flat probes) on the three
packs, ``embed_bag`` (V = 100k, E = 128, B = 256, L = 16) beside
``F.embedding_bag``, and one FPF run of 315 rounds on a 5,622-row sample
of the index's documents (the build's sample size) through
``fpf_centers_fused``, whole and per round;
and on the host clock (synchronised) one fused engine call at probes 12
and a second 100k ``Retriever.build`` (the first one, which builds the
index, also compiles what the tree compiles on first use). Prints one JSON
line with the card's name and power limit. Needs a CUDA card.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Retriever, get_engine, weighted_query  # noqa: E402
from repro_torch.data import CorpusConfig, make_corpus  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    bucket_score, bucket_score_tiled, embed_bag, fpf_centers_fused,
    resolve_device, topk_score)


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
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    docs, spec, _ = make_corpus(CorpusConfig(n_docs=100_000, seed=0))

    def build():
        return Retriever.build(
            docs, spec, 316, n_clusterings=3, method="auto", device=dev,
            generator=torch.Generator().manual_seed(0), backend="fused").index

    index = build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    qids = rng.choice(100_000, 64, replace=False)
    w = rng.dirichlet([1.0] * spec.s, size=64).astype(np.float32)
    qw = weighted_query(index.docs[torch.as_tensor(qids, device=dev)],
                        torch.as_tensor(w), spec)
    excl = torch.as_tensor(qids, dtype=torch.int32, device=dev)
    out = {"tree": label, "card": card}
    packs = {pd: index if pd == "float32" else dataclasses.replace(
        index, bucket_data=None, bucket_scales=None, pack_dtype=pd)
        for pd in ("float32", "bfloat16", "int8")}
    for pd, idx in packs.items():
        _, a, k = get_engine(idx, "fused").kernel_inputs(
            qw, probes=12, k=10, exclude=excl)
        out[f"bucket_score_tiled[{pd}]"] = ms(
            lambda: bucket_score_tiled(*a, **k), 20)
    _, a, k = get_engine(index, "fused").kernel_inputs(
        qw, probes=948, k=10, exclude=excl)
    out["bucket_score_tiled[exact tier]"] = ms(
        lambda: bucket_score_tiled(*a, **k), 3)
    out["topk_score"] = ms(
        lambda: topk_score(qw, index.docs, k=11, exclude=excl), 20)
    eng = get_engine(index, "fused")
    flat = eng._flat_probes(qw, eng._probes_t(12))
    for pd, idx in packs.items():
        data, ids, _ = idx.ensure_bucket_major()
        out[f"bucket_score[{pd}]"] = ms(
            lambda: bucket_score(qw, data, ids, flat, k=10, exclude=excl), 20)
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn(100_000, 128, device=dev, generator=g)
    bidx = torch.randint(-1, 100_000, (256, 16), device=dev,
                         dtype=torch.int32, generator=g)
    table_ext = torch.cat([table, table.new_zeros((1, 128))])
    idx_ext = torch.where(bidx >= 0, bidx, 100_000).long()
    out["embed_bag"] = ms(lambda: embed_bag(table, bidx), 200)
    out["F.embedding_bag"] = ms(lambda: torch.nn.functional.embedding_bag(
        idx_ext, table_ext, mode="sum", padding_idx=100_000), 200)
    perm = torch.randperm(100_000, generator=torch.Generator().manual_seed(7))
    x = index.docs[perm[:5622].to(dev)].contiguous()
    out["fpf 315 rounds"] = ms(lambda: fpf_centers_fused(x, 316, 5), 5)
    out["fpf_iter per round (build loop)"] = out["fpf 315 rounds"] / 315
    eng.search(qw, probes=12, k=10, exclude=excl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        eng.search(qw, probes=12, k=10, exclude=excl)
    torch.cuda.synchronize()
    out["fused engine call, probes 12 (host ms)"] = (
        (time.perf_counter() - t0) * 1e3 / 5)
    out["Retriever.build 100k (host s)"] = build_s
    print("[port_kernel_times] " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

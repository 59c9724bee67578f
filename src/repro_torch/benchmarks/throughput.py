"""Serving throughput: QPS against batch size, per search backend and pack
dtype (port of the reference's ``benchmarks/throughput.py``).

A batch shares one probe-dedup schedule per query tile, so a bucket probed
by several queries of a tile is read once for all of them; bf16 and int8
packs halve and quarter the bytes of each read. Measured at the engine
seam (one ``engine.search`` call per batch, the call
``Retriever._search_batch`` makes per execution shape), so the numbers
leave out request resolution and response assembly.

Every entry is labelled with its backend, batch, ``pack_dtype``,
``query_tile``, ``n_shards`` (sharded rows), the device and the card's
name and power limit (``benchmarks/common.py``), with the QPS from the
median and the p50 / p99 per-query latency over the repeats (at a few
repeats the p99 is the largest: it catches a spike the median hides, it
claims no tail statistics). Sharded rows also carry the packed bytes per
query their schedule reads, and :func:`_check_sharded_pack_ratio` gates
them: bf16 exactly 1/2, int8 exactly 1/4 of fp32 at the same batch.

Run::

    PYTHONPATH=src python -m repro_torch.benchmarks.throughput \
        --scale quick [--backend sharded --shards 4] [--device cpu]

The JSON goes to the git-ignored ``benchmarks/_results/``
(``throughput_<scale>.json``) unless ``--out`` names a path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import ClusterPruneIndex, available_backends, get_engine
from ..kernels import pick_query_tile
from ..kernels.common import pad_to, resolve_device
from .common import (bench_sizes, card_line, make_bench_corpus, run_info,
                     std_parser, timed_all, write_json)

__all__ = ["run", "K_NN", "PROBES", "BATCH_SIZES"]

K_NN = 10
PROBES = 12
BATCH_SIZES = (1, 8, 64)
REPEATS = 5


def _query_tile(engine, data, nq: int, k: int) -> int:
    """The tile ``engine`` runs a batch of ``nq`` at: its option, else
    the kernel's tile floored by the batch (as the fused and sharded
    engines pick it)."""
    if engine.query_tile is not None:
        return int(engine.query_tile)
    n_buckets, b, d = (int(x) for x in data.shape[-3:])
    return min(pick_query_tile(d, b, k_pad=pad_to(k, 8),
                               pack_itemsize=data.element_size()),
               pad_to(nq, 8))


def _sharded_pack_stats(engine, qw, probes: int, k: int):
    """Packed bytes per query the sharded path reads, and its serving
    tile. The byte count fixes the schedule to the fp32 pack's tile, so
    rows differ only in storage itemsize: an int8 pack reads exactly 1/4
    of fp32's bytes (the engine's own tile is never smaller for a narrower
    pack). Every shard reads its ``(B_l, D)`` slice of each scheduled
    bucket, hence the ``n_shards`` factor."""
    from ..kernels.bucket_score import (
        build_probe_schedule_device, schedule_block_reads, schedule_length,
    )

    data = engine._ensure_placed()[0]
    n_shards = engine.n_shards
    n_buckets, b_l, d = (int(x) for x in data[0].shape)
    nq = int(qw.shape[0])
    flat = engine._flat_probes(qw, engine._probes_t(probes))
    qt_serve = _query_tile(engine, data[0], nq, k)
    qt_sched = min(pick_query_tile(d, b_l, k_pad=pad_to(k, 8),
                                   pack_itemsize=4), pad_to(nq, 8))
    s_len = schedule_length(qt_sched, int(flat.shape[1]), n_buckets)
    _, member = build_probe_schedule_device(flat, query_tile=qt_sched,
                                            s_len=s_len)
    reads = schedule_block_reads(member)
    per_q = n_shards * reads * b_l * d * data[0].element_size() / nq
    return per_q, qt_serve


def run(scale: str = "quick", seed: int = 0, batch_sizes=BATCH_SIZES,
        backends=None, pack_dtypes=(None, "bfloat16", "int8"),
        rescore=None, n_shards: int | None = None, device=None,
        repeats: int = REPEATS):
    """A list of labelled throughput entries. The fused and sharded
    backends run once per pack dtype (the same index re-packed, so the
    clustering is held fixed); the reference backend scores the fp32
    corpus, one row per batch. ``n_shards`` goes to the sharded engine
    (default: one shard per visible device). The sharded rows' byte ratios
    are gated (:func:`_check_sharded_pack_ratio`)."""
    dev = resolve_device(device)
    sz = bench_sizes(scale)
    docs, spec = make_bench_corpus(sz, seed, dev)
    index = ClusterPruneIndex.build(
        docs, spec, sz["k_clusters"], n_clusterings=3, method="auto",
        generator=torch.Generator().manual_seed(seed), pack_major=True,
        device=dev)
    # one query draw per batch size, shared by every backend x pack row:
    # rows at one batch score the same queries (and probe sets), which is
    # what lets the byte-ratio gate hold the schedule fixed across packs
    rng = np.random.default_rng(seed)
    qids_by_bs = {bs: rng.choice(sz["n_docs"], bs, replace=False)
                  for bs in batch_sizes}
    if backends is None:
        backends = available_backends()
    card = card_line(dev)
    print(f"\n# Throughput: QPS vs batch size (n={sz['n_docs']}, "
          f"probes={PROBES}, k={K_NN}, rescore={rescore}, device={dev}, "
          f"card={card})")
    print("backend,pack_dtype,query_tile,n_shards,batch,qps,"
          "p50_ms_per_query,p99_ms_per_query")
    entries = []
    for name in backends:
        dtypes = pack_dtypes if name in ("fused", "sharded") else (None,)
        opts = ({"n_shards": n_shards}
                if name == "sharded" and n_shards is not None else {})
        for pd in dtypes:
            idx = index if pd is None else dataclasses.replace(
                index, bucket_data=None, bucket_scales=None, pack_dtype=pd)
            engine = get_engine(idx, name, **opts)
            label = pd or "float32"
            for bs in batch_sizes:
                qids = torch.as_tensor(qids_by_bs[bs], device=dev)
                qw = docs[qids]
                ex = qids.to(torch.int32)
                ts, _ = timed_all(
                    lambda e=engine, q=qw, x=ex: e.search(
                        q, probes=PROBES, k=K_NN, exclude=x,
                        rescore=rescore),
                    dev, repeats=repeats)
                per_query_ms = np.asarray(ts, np.float64) / bs * 1e3
                t = float(np.median(ts))
                entry = {
                    "backend": name, "batch": bs, "qps": bs / t,
                    "ms_per_query": t / bs * 1e3,
                    "p50_ms_per_query": float(np.percentile(per_query_ms,
                                                            50)),
                    "p99_ms_per_query": float(np.percentile(per_query_ms,
                                                            99)),
                    "pack_dtype": label, "query_tile": None,
                    "n_shards": None, "rescore": rescore,
                    "device": str(dev), "card": card,
                }
                if name == "fused":
                    entry["query_tile"] = _query_tile(
                        engine, idx.ensure_bucket_major()[0], bs, K_NN)
                elif name == "sharded":
                    per_q, qt_s = _sharded_pack_stats(engine, qw, PROBES,
                                                      K_NN)
                    entry.update(query_tile=qt_s, n_shards=engine.n_shards,
                                 packed_bytes_per_query=per_q)
                entries.append(entry)
                print(f"{name},{label},{entry['query_tile']},"
                      f"{entry['n_shards']},{bs},{entry['qps']},"
                      f"{entry['p50_ms_per_query']},"
                      f"{entry['p99_ms_per_query']}")
    _check_sharded_pack_ratio(entries)
    return entries


def _check_sharded_pack_ratio(entries) -> int:
    """Gate: at one batch, a sharded int8 pack reads exactly 1/4 (bf16
    exactly 1/2) of the packed bytes of sharded fp32, since the schedule is
    held fixed and only the storage itemsize differs. Raises
    ``AssertionError`` otherwise; returns the number of rows checked."""
    by = {(e["batch"], e["pack_dtype"]): e["packed_bytes_per_query"]
          for e in entries
          if e["backend"] == "sharded" and "packed_bytes_per_query" in e}
    checked = 0
    for (bs, pd), v in by.items():
        base = by.get((bs, "float32"))
        if base is None or pd == "float32":
            continue
        want = {"bfloat16": 2.0, "int8": 4.0}[pd]
        if abs(base / v - want) >= 1e-6:
            raise AssertionError(
                f"sharded {pd} packed bytes/query {v} is not 1/{want:.0f} "
                f"of fp32 ({base}) at batch {bs}")
        checked += 1
    if checked:
        print(f"# sharded pack-dtype byte ratios verified ({checked} "
              f"entries: bf16=1/2, int8=1/4 of fp32)")
    return checked


def main(argv=None):
    ap = std_parser(__doc__)
    ap.add_argument("--pack-dtype", default=None,
                    choices=["float32", "bfloat16", "int8"],
                    help="one bucket-major storage dtype for the fused and "
                         "sharded backends (default: all three)")
    ap.add_argument("--rescore", type=int, default=None,
                    help="exact-rescore tail depth (>= k) on every search")
    ap.add_argument("--backend", default=None,
                    choices=list(available_backends()),
                    help="one backend (default: every registered one)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the sharded backend (default: one per "
                         "visible device)")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes (default 1,8,64)")
    args = ap.parse_args(argv)
    dts = ((None, "bfloat16", "int8") if args.pack_dtype is None
           else (None,) if args.pack_dtype == "float32"
           else (args.pack_dtype,))
    entries = run(
        args.scale, args.seed,
        batch_sizes=(BATCH_SIZES if args.batches is None
                     else tuple(int(b) for b in args.batches.split(","))),
        backends=None if args.backend is None else (args.backend,),
        pack_dtypes=dts, rescore=args.rescore, n_shards=args.shards,
        device=args.device)
    dev = resolve_device(args.device)
    write_json({**run_info("throughput", args.scale, args.seed, dev),
                "entries": entries}, args.out)


if __name__ == "__main__":
    main()

"""Retrieval serving driver on PyTorch — the paper's system end to end
(port of :mod:`repro.launch.serve`).

Builds the corpus and the FPF multi-clustering index behind a
:class:`repro_torch.core.Retriever` (on the card, ``fpf_fused``: the FPF
rounds run in the CUDA ``fpf_iter`` kernel), then serves batched
more-like-this requests with per-request Dirichlet field weights and checks
quality against exact brute force::

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 100000 \
        --queries 64 --probes 12 --k 10 --backend fused

``--backend`` picks the engine (``auto``: ``sharded`` on more than one
card, ``fused`` on one, ``reference`` on the CPU); ``--shards N`` runs the
``sharded`` backend with N shards over the visible devices (several shards
may share one card or the CPU: the port's counterpart of the reference's
forced host devices); ``--compare`` serves the same requests through
every backend on the same index; ``--exact`` serves the exact tier and
checks it against brute force id for id; ``--pack-dtype`` stores the
bucket-major pack in bf16 or int8; ``--device cpu`` runs the plain
versions of the kernels. ``--recall-target 0.9`` replaces ``--probes``
with a budget planned from the index's calibrated ladder (fitted right
after the build, on held-out queries: seed + 1), and the report prints the
planner's predicted recall beside the achieved one; ``--min-recall 0.9``
starts at ``--probes`` and escalates up the ladder's rungs (ultimately the
exact tier) while the predicted recall is below the floor, prints the
tiers and escalations, and fails unless the achieved recall is at least
the floor minus 0.05. Ground truth is the ``topk_score`` kernel.
``--mutate N`` then adds exact copies of the first N query documents
through ``retriever.add`` (no rebuild), checks that each copy is hit #1 for
``like=`` its original, removes the copies again and checks that they never
come back; a miss exits non-zero. ``--serve`` then drives the same requests
through the async micro-batching tier (:mod:`repro_torch.serving`;
``--window-ms``, ``--replicas``, each replica on its own CUDA stream) as
concurrent submits and checks every answer against one-by-one synchronous
search (ids equal, scores within ``rtol=1e-5, atol=1e-6``); ``--chaos
PROFILE`` injects a named fault profile into that pool (implies
``--serve``, at least 4 replicas) and prints each replica's health, where
a typed failure or a ``degraded=True`` answer is an acceptable outcome and
a non-degraded answer that differs is not. Any mismatch exits non-zero.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import (
    ClusterPruneIndex,
    Retriever,
    SearchRequest,
    available_backends,
    brute_force_bottomk,
    brute_force_topk,
    calibrate_index,
    competitive_recall,
    normalized_aggregate_goodness,
    weighted_query,
)
from ..data import CorpusConfig, make_corpus
from ..kernels.common import resolve_device

__all__ = ["build_index", "build_retriever", "make_requests",
           "mutate_round_trip", "serve_requests", "serve_async", "main"]


def build_index(n_docs: int = 20_000, *, k_clusters: int | None = None,
                n_clusterings: int = 3, seed: int = 0,
                pack_major: bool | None = None, pack_dtype=None,
                method: str = "auto", device=None):
    """Corpus + index on ``device`` -> ``(index, docs, spec)``. ``K``
    defaults to ``max(16, sqrt(n))``, as the reference."""
    dev = resolve_device(device)
    docs_np, spec, _ = make_corpus(CorpusConfig(n_docs=n_docs, seed=seed))
    docs = torch.as_tensor(docs_np, device=dev)
    if k_clusters is None:
        k_clusters = max(16, int(np.sqrt(n_docs)))
    index = ClusterPruneIndex.build(
        docs, spec, k_clusters, n_clusterings=n_clusterings, method=method,
        generator=torch.Generator().manual_seed(seed), pack_major=pack_major,
        pack_dtype=pack_dtype, device=dev,
    )
    return index, docs, spec


def build_retriever(n_docs: int = 20_000, *, backend: str = "auto",
                    k_clusters: int | None = None, n_clusterings: int = 3,
                    seed: int = 0, pack_major: bool | None = None,
                    pack_dtype=None, method: str = "auto", device=None,
                    calibrate: bool = False, calibrate_opts=None,
                    engine_opts=None):
    """Corpus + index + facade in one call -> ``(retriever, docs, spec)``.
    ``calibrate=True`` arms lazy planner calibration: the first
    ``recall_target=`` / ``min_recall=`` request fits the index's
    ladder (``calibrate_opts`` pass sampling options through);
    ``engine_opts`` go to the retriever's backend (e.g.
    ``{"n_shards": 4}`` for ``sharded``)."""
    index, docs, spec = build_index(
        n_docs, k_clusters=k_clusters, n_clusterings=n_clusterings,
        seed=seed, pack_major=pack_major, pack_dtype=pack_dtype,
        method=method, device=device,
    )
    return Retriever(index, backend=backend, calibrate=calibrate,
                     calibrate_opts=calibrate_opts,
                     engine_opts=engine_opts), docs, spec


def make_requests(qids, weights, spec, *, probes: int | None = None,
                  k: int = 10, recall_target: float | None = None,
                  backend: str | None = None, exact: bool = False,
                  min_recall: float | None = None) -> list[SearchRequest]:
    """One more-like-this request per query doc id, each with its own
    field-name weights (``exact=True`` drops any budget)."""
    weights = np.asarray(weights, np.float32)
    if exact:
        probes = recall_target = min_recall = None
    return [
        SearchRequest(
            like=int(qid),
            weights=dict(zip(spec.names, map(float, w))),
            probes=probes, k=k, recall_target=recall_target, backend=backend,
            exact=exact, min_recall=min_recall,
        )
        for qid, w in zip(np.asarray(qids), weights)
    ]


def serve_requests(retriever: Retriever, requests):
    """Serve a batch through the facade -> list[SearchResponse]."""
    return retriever.search(requests)


def serve_async(retriever: Retriever, requests, *, window_s: float = 0.002,
                replicas: int = 1, deadline_s: float | None = None,
                chaos: str | None = None, seed: int = 0):
    """Drive requests through the async micro-batching tier.

    Every request is submitted concurrently (the micro-batch window
    coalesces them into engine-sized batches). Returns ``(responses,
    stats_line, health)`` with responses in request order, each carrying
    the server-stamped ``queue_wait_s`` / ``compute_s`` split; ``health``
    is the final per-replica health snapshot. ``chaos`` names a profile of
    :data:`repro_torch.serving.FAULT_PROFILES` to inject into the pool;
    under chaos a response slot may hold a typed
    :class:`~repro_torch.serving.ServingError` instead of a response.
    """
    import asyncio

    from ..serving import FaultPolicy, ResilienceConfig, SearchServer

    policy = FaultPolicy.named(chaos, seed=seed) if chaos else None
    cfg = ResilienceConfig(seed=seed) if chaos else None
    # Fault handling is per dispatch: one giant coalesced batch gives the
    # breaker/retry machinery a single roll of the dice, so under chaos cap
    # the batch size to spread work across replicas.
    max_batch = 8 if chaos else None  # None -> default_max_batch

    async def _run():
        async with SearchServer(retriever, window_s=window_s,
                                replicas=replicas, max_batch=max_batch,
                                resilience=cfg,
                                fault_policy=policy) as server:
            resps = await asyncio.gather(
                *(server.submit(r, deadline_s=deadline_s)
                  for r in requests),
                return_exceptions=bool(chaos),
            )
            line = server.stats.format_line()
            health = server.pool.health_snapshot()
        return list(resps), line, health

    return asyncio.run(_run())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--probes", type=int, default=12)
    ap.add_argument("--recall-target", type=float, default=None,
                    help="plan probes from a recall target through the "
                         "per-index calibrated ladder (overrides --probes; "
                         "the index is calibrated after build)")
    ap.add_argument("--min-recall", type=float, default=None,
                    help="recall floor: requests run at --probes and "
                         "escalate up the calibrated ladder (ultimately the "
                         "exact tier) while predicted recall is below it; "
                         "the index is calibrated after build")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=("auto",) + available_backends(),
                    help="search engine backend (auto = device pick)")
    ap.add_argument("--shards", type=int, default=None, metavar="N",
                    help="--backend sharded: the number of shards (default "
                         "one per visible device; several may share one)")
    ap.add_argument("--pack-dtype", default=None,
                    choices=("float32", "bfloat16", "int8"),
                    help="storage dtype of the bucket-major pack")
    ap.add_argument("--exact", action="store_true",
                    help="serve every request through the exact tier and "
                         "check the answers against brute force id for id")
    ap.add_argument("--compare", action="store_true",
                    help="serve the same requests through every backend")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--serve", action="store_true",
                    help="also drive the requests through the async "
                         "micro-batching tier (repro_torch.serving) as "
                         "concurrent submits and check them against "
                         "one-by-one synchronous search")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="--serve micro-batch window")
    ap.add_argument("--replicas", type=int, default=1,
                    help="--serve dispatch replicas (one CUDA stream each)")
    ap.add_argument("--chaos", default=None, metavar="PROFILE",
                    help="inject a named fault profile (repro_torch.serving."
                         "FAULT_PROFILES, e.g. hang_flap) into the --serve "
                         "pool and print each replica's health; implies "
                         "--serve, with at least 4 replicas")
    ap.add_argument("--mutate", type=int, default=0, metavar="N",
                    help="after serving, add exact copies of the first N "
                         "query documents through retriever.add (no "
                         "rebuild), check each is hit #1 for like= its "
                         "original, then remove them and check they are "
                         "gone")
    args = ap.parse_args(argv)
    if args.exact and (args.recall_target is not None
                       or args.min_recall is not None):
        ap.error("--exact already guarantees recall 1.0; it cannot combine "
                 "with --recall-target or --min-recall")
    if args.shards is not None and (args.backend != "sharded"
                                    or args.shards < 1):
        ap.error("--shards N (N >= 1) goes with --backend sharded")
    if args.chaos is not None:
        from ..serving import FAULT_PROFILES

        if args.chaos not in FAULT_PROFILES:
            ap.error(f"--chaos {args.chaos!r}: unknown profile; known: "
                     f"{', '.join(sorted(FAULT_PROFILES))}")
        args.serve = True
        args.replicas = max(args.replicas, 4)

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    retriever, docs, spec = build_retriever(
        args.docs, backend=args.backend, seed=args.seed,
        pack_dtype=args.pack_dtype, device=dev,
        engine_opts=(None if args.shards is None
                     else {"n_shards": args.shards}),
    )
    index = retriever.index
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[serve] index built in {time.perf_counter() - t0:.1f}s on {dev} "
          f"(method={index.method}, K={index.leaders.shape[1]}, "
          f"T={index.leaders.shape[0]}, B={index.buckets.shape[2]})")

    if args.recall_target is not None or args.min_recall is not None:
        t0 = time.perf_counter()
        # seed + 1: the served queries below are drawn with args.seed, so
        # the achieved recall is measured on held-out queries and weights
        ladder = calibrate_index(index, seed=args.seed + 1)
        rungs = ", ".join(f"{p}->{r:.2f}"
                          for p, r in zip(ladder.probes, ladder.recall))
        print(f"[serve] planner calibrated in "
              f"{time.perf_counter() - t0:.1f}s (probes->recall: {rungs})")

    rng = np.random.default_rng(args.seed)
    qids = rng.choice(args.docs, args.queries, replace=False)
    w = rng.dirichlet([1.0] * spec.s, size=args.queries).astype(np.float32)
    qw = weighted_query(docs[torch.as_tensor(qids, device=dev)],
                        torch.as_tensor(w), spec)
    exclude = torch.as_tensor(qids, dtype=torch.int32, device=dev)
    gt_s, gt_i = brute_force_topk(docs, qw, args.k, exclude=exclude)
    far_s, _ = brute_force_bottomk(docs, qw, args.k, exclude=exclude)

    backends = (list(available_backends()) if args.compare
                else [retriever.backend])
    report = []
    for name in backends:
        if args.recall_target is not None:
            requests = make_requests(qids, w, spec,
                                     recall_target=args.recall_target,
                                     k=args.k, backend=name,
                                     min_recall=args.min_recall)
        else:
            requests = make_requests(qids, w, spec, probes=args.probes,
                                     k=args.k, backend=name, exact=args.exact,
                                     min_recall=args.min_recall)
        responses = serve_requests(retriever, requests)
        dt = responses[0].latency_s
        ids = torch.as_tensor(np.stack([r.doc_ids for r in responses]))
        scores = torch.as_tensor(np.stack([r.scores for r in responses]))
        n_scored = np.asarray([r.n_scored for r in responses], np.float64)
        cr = float(competitive_recall(ids, gt_i.cpu()).mean())
        nag = float(normalized_aggregate_goodness(
            scores, gt_s.cpu(), far_s.cpu()).mean())
        frac = float(n_scored.mean()) / args.docs
        report.append((name, dt, cr, nag, frac))
        print(f"[serve] backend={name}: {args.queries} requests in "
              f"{dt * 1e3:.1f} ms ({dt / args.queries * 1e3:.2f} ms/request)")
        planner = ""
        if args.recall_target is not None:
            planner = (f" [target {args.recall_target:.2f}, planner "
                       f"predicted {responses[0].predicted_recall:.2f} "
                       f"@ {responses[0].probes} probes]")
        print(f"[serve] backend={name}: recall@{args.k} = {cr:.2f}/{args.k}, "
              f"NAG = {nag:.4f}, scored {frac:.1%} of corpus{planner}")
        if args.exact or args.min_recall is not None:
            tiers: dict[str, int] = {}
            for resp in responses:
                tiers[resp.tier] = tiers.get(resp.tier, 0) + 1
            esc = sum(resp.escalations for resp in responses)
            print(f"[serve] backend={name}: tiers {tiers}, "
                  f"{esc} escalations")
        if args.exact:
            wrong = int(np.sum(np.any(ids.numpy() != gt_i.cpu().numpy(),
                                      axis=-1)))
            print(f"[serve] backend={name}: exact-tier parity vs brute "
                  f"force: {wrong} mismatches "
                  f"({'OK' if wrong == 0 else 'FAIL'})")
            if wrong:
                raise SystemExit(
                    f"[serve] exact tier returned {wrong} answers "
                    f"differing from brute force"
                )
        if args.min_recall is not None:
            achieved = cr / args.k
            ok = achieved >= args.min_recall - 0.05   # held-out queries
            print(f"[serve] backend={name}: recall floor "
                  f"{args.min_recall:.2f}: achieved {achieved:.2f} "
                  f"({'OK' if ok else 'FAIL'})")
            if not ok:
                raise SystemExit(
                    f"[serve] min-recall floor {args.min_recall} missed: "
                    f"achieved {achieved:.2f} on held-out queries"
                )
    if args.serve:
        serve_tier(retriever, args, qids, w, spec)
    if len(report) > 1:
        print("\n[serve] per-backend latency (same index, same requests)")
        print("backend,ms_per_request,recall,nag,corpus_scanned")
        for name, dt, cr, nag, frac in report:
            print(f"{name},{dt / args.queries * 1e3:.3f},{cr:.2f},"
                  f"{nag:.4f},{frac:.3f}")
    if args.mutate > 0:
        mutate_round_trip(retriever, docs, spec, qids[:args.mutate],
                          w[:args.mutate], probes=args.probes, k=args.k)


def serve_tier(retriever: Retriever, args, qids, w, spec) -> None:
    """``--serve`` / ``--chaos``: the same query set as concurrent submits
    through the async tier on the retriever's own backend, checked against
    one-by-one synchronous search; raises ``SystemExit`` on a mismatch.
    The request caches are flushed first and after: the synchronous pass
    already answered these queries, and a cache hit would let either side
    skip the engine."""
    requests = make_requests(
        qids, w, spec, k=args.k,
        probes=(None if args.recall_target is not None or args.exact
                else args.probes),
        recall_target=args.recall_target, exact=args.exact,
        min_recall=args.min_recall,
    )
    retriever._flush_request_caches()
    if args.chaos:
        from ..serving import FaultPolicy

        print(f"[serve] chaos: injecting "
              f"{FaultPolicy.named(args.chaos, seed=args.seed).describe()} "
              f"across {args.replicas} replicas")
    t0 = time.perf_counter()
    async_resps, stats_line, health = serve_async(
        retriever, requests, window_s=args.window_ms / 1e3,
        replicas=args.replicas, chaos=args.chaos, seed=args.seed,
    )
    dt = time.perf_counter() - t0
    retriever._flush_request_caches()
    one_by_one = [retriever.search(r) for r in requests]
    ok_resps = [r for r in async_resps if not isinstance(r, Exception)]
    failed = len(async_resps) - len(ok_resps)
    degraded = sum(1 for r in ok_resps if r.degraded)
    # a typed failure or a degraded=True answer is an honest chaos outcome;
    # a non-degraded answer that differs from the synchronous one is not
    mismatches = sum(
        1 for a, b in zip(async_resps, one_by_one)
        if not isinstance(a, Exception) and not a.degraded
        and (list(a.doc_ids) != list(b.doc_ids)
             or not np.allclose(a.scores, b.scores, rtol=1e-5, atol=1e-6))
    )
    if ok_resps:
        waits = np.asarray([r.queue_wait_s for r in ok_resps]) * 1e3
        comps = np.asarray([r.compute_s for r in ok_resps]) * 1e3
        print(f"[serve] async tier: {len(requests)} concurrent submits in "
              f"{dt * 1e3:.1f} ms on {args.replicas} replica(s) (mean batch "
              f"{np.mean([r.batch_size for r in ok_resps]):.1f}, wait "
              f"p50 {np.percentile(waits, 50):.1f} ms, compute p50 "
              f"{np.percentile(comps, 50):.1f} ms)")
    print(f"[serve] async stats: {stats_line}")
    if args.chaos:
        print(f"[serve] chaos outcome: {len(ok_resps)} answered "
              f"({degraded} degraded), {failed} failed typed")
        for h in health:
            print(f"[serve] replica {h['idx']}: {h['state']:>9} "
                  f"ewma={h['ewma_ms']} ms, "
                  f"{h['successes']}/{h['dispatches']} ok, "
                  f"{h['timeouts']} timeouts, trips "
                  f"{h['trips']}/{h['recoveries']} recovered")
    print(f"[serve] async parity vs one-by-one: {mismatches} mismatches "
          f"({'OK' if mismatches == 0 else 'FAIL'})")
    if mismatches:
        raise SystemExit(
            f"[serve] async serving tier returned {mismatches} responses "
            f"differing from the synchronous path"
        )


def mutate_round_trip(retriever: Retriever, docs, spec, src, weights, *,
                      probes: int, k: int) -> None:
    """Add exact copies of the documents ``src`` (a copy is its original's
    nearest neighbour), check that each is hit #1 for ``like=`` its
    original, remove them, and check that none comes back; raises
    ``SystemExit`` on a miss."""
    dev = retriever.index.docs.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    src = np.asarray(src)
    t0 = time.perf_counter()
    new_ids = retriever.add(docs[torch.as_tensor(src, device=dev)])
    sync()
    dt_add = time.perf_counter() - t0
    reqs = make_requests(src, weights, spec, probes=probes, k=k)
    responses = serve_requests(retriever, reqs)
    found = sum(1 for r, nid in zip(responses, new_ids)
                if r.hits and r.hits[0].doc_id == int(nid))
    print(f"[serve] mutate: added {len(src)} docs in {dt_add * 1e3:.1f} ms "
          f"(no rebuild, index now {retriever.index.n_live} live docs); "
          f"{found}/{len(src)} copies came back as hit #1")
    t0 = time.perf_counter()
    retriever.remove(new_ids)
    sync()
    dt_rm = time.perf_counter() - t0
    responses = serve_requests(retriever, reqs)
    gone = set(map(int, new_ids))
    leaked = sum(1 for r in responses
                 if any(h.doc_id in gone for h in r.hits))
    print(f"[serve] mutate: removed them again in {dt_rm * 1e3:.1f} ms; "
          f"{leaked} leaked back into any top-k "
          f"({'OK' if leaked == 0 else 'FAIL'})")
    if found < len(src) or leaked:
        raise SystemExit(
            f"[serve] mutate round-trip failed: {found}/{len(src)} adds "
            f"retrieved, {leaked} removals leaked"
        )


if __name__ == "__main__":
    main()

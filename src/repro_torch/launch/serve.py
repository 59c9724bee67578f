"""Retrieval serving driver on PyTorch — the paper's system end to end
(port of :mod:`repro.launch.serve`).

Builds the corpus and the FPF multi-clustering index behind a
:class:`repro_torch.core.Retriever` (on the card, ``fpf_fused``: the FPF
rounds run in the CUDA ``fpf_iter`` kernel), then serves batched
more-like-this requests with per-request Dirichlet field weights and checks
quality against exact brute force::

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 100000 \
        --queries 64 --probes 12 --k 10 --backend fused

``--backend`` picks the engine (``auto``: ``fused`` on the card,
``reference`` on the CPU); ``--compare`` serves the same requests through
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

Not ported yet: ``--serve`` / ``--chaos`` (the async serving tier),
``--mutate`` (incremental maintenance).
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
           "serve_requests", "main"]


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
                    pack_dtype=None, method: str = "auto", device=None):
    """Corpus + index + facade in one call -> ``(retriever, docs, spec)``."""
    index, docs, spec = build_index(
        n_docs, k_clusters=k_clusters, n_clusterings=n_clusterings,
        seed=seed, pack_major=pack_major, pack_dtype=pack_dtype,
        method=method, device=device,
    )
    return Retriever(index, backend=backend), docs, spec


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
    args = ap.parse_args(argv)
    if args.exact and (args.recall_target is not None
                       or args.min_recall is not None):
        ap.error("--exact already guarantees recall 1.0; it cannot combine "
                 "with --recall-target or --min-recall")

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    retriever, docs, spec = build_retriever(
        args.docs, backend=args.backend, seed=args.seed,
        pack_dtype=args.pack_dtype, device=dev,
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
    if len(report) > 1:
        print("\n[serve] per-backend latency (same index, same requests)")
        print("backend,ms_per_request,recall,nag,corpus_scanned")
        for name, dt, cr, nag, frac in report:
            print(f"{name},{dt / args.queries * 1e3:.3f},{cr:.2f},"
                  f"{nag:.4f},{frac:.3f}")


if __name__ == "__main__":
    main()

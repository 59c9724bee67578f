"""End-to-end serving: build a Retriever, serve a HETEROGENEOUS batch of
typed requests — more-like-this and keyword-vector queries, per-request
weights, mixed probe budgets and recall targets — and verify quality
online (port of ``examples/serve_retrieval.py``)::

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval \
        [--docs 20000] [--queries 128] [--device cpu]

The recall-target half of the batch exercises the calibrated planner: the
retriever is created with ``calibrate=True``, so the first
``recall_target=`` request fits the per-index recall->probes ladder, and
the responses carry the planner's predicted recall, checked against the
achieved one. The final section serves a MUTATING corpus: repeat requests
hit the response cache, new documents are ingested through
``retriever.add`` (no rebuild) and must displace the cached answers as hit
#1, then ``retriever.remove`` tombstones them and they may never come back;
either failure exits non-zero. Built through
:func:`repro_torch.launch.serve.build_retriever`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import (
    SearchRequest, brute_force_topk, competitive_recall, weighted_query,
)
from ..kernels.common import resolve_device
from ..launch.serve import build_retriever

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_docs, n_q, k = args.docs, min(args.queries, args.docs // 4), 10

    retriever, docs, spec = build_retriever(
        n_docs, backend="auto", calibrate=True, device=dev,
        calibrate_opts={"n_queries": 48, "n_weight_draws": 4},
    )
    print(f"[serve_retrieval] backend={retriever.backend}, "
          f"fields={spec.names}, docs={n_docs}, device={dev}")

    rng = np.random.default_rng(0)
    qids = rng.choice(n_docs, n_q, replace=False)
    wmat = rng.dirichlet([1.0] * spec.s, size=n_q).astype(np.float32)
    half = n_q // 2

    # Heterogeneous request batch — the facade groups compatible execution
    # shapes into one engine call each and returns responses in order:
    #   first half: more-like-this with explicit probe budgets,
    #   second half: raw keyword-embedding vectors with a recall target
    #   that the CALIBRATED per-index ladder maps to a probe budget.
    requests = [
        SearchRequest(like=int(qid),
                      weights=dict(zip(spec.names, map(float, w))),
                      probes=12, k=k)
        for qid, w in zip(qids[:half], wmat[:half])
    ] + [
        SearchRequest(query=docs[int(qid)], weights=tuple(map(float, w)),
                      exclude=int(qid), recall_target=0.8, k=k)
        for qid, w in zip(qids[half:], wmat[half:])
    ]
    responses = retriever.search(requests)

    # online quality check against exact brute force (same §4 reduction)
    qt = torch.as_tensor(qids, device=dev)
    qw = weighted_query(docs[qt], torch.as_tensor(wmat, device=dev), spec)
    _, gt_i = brute_force_topk(docs, qw, k, exclude=qids)
    ids = torch.as_tensor(np.stack([r.doc_ids for r in responses]),
                          device=dev)
    cr = competitive_recall(ids, gt_i).float()
    recall = float(cr.mean())

    by_shape = {}
    for r in responses:
        by_shape.setdefault((r.backend, r.probes, len(r.doc_ids)),
                            []).append(r)
    for (backend, probes, kk), rs in sorted(by_shape.items()):
        scanned = np.mean([r.n_scored for r in rs]) / n_docs
        print(f"[serve_retrieval] {len(rs)} requests via {backend} "
              f"(probes={probes}, k={kk}): {rs[0].latency_s * 1e3:.1f} "
              f"ms/batch, scanned {scanned:.1%} of corpus")

    # the planner's promise vs what the recall-target half achieved
    planned = responses[half:]
    achieved = float(cr[half:].mean()) / k
    print(f"[serve_retrieval] recall_target=0.8 half: planner chose "
          f"{planned[0].probes} probes, predicted recall "
          f"{planned[0].predicted_recall:.2f}, achieved {achieved:.2f}")
    print(f"[serve_retrieval] batch recall@{k} = {recall:.2f}/{k} "
          f"over {len(requests)} mixed requests")

    # --- serve a MUTATING corpus: cache -> add -> invalidate -> remove ----
    mut_qids = qids[: max(4, n_q // 8)]
    mut_reqs = [
        SearchRequest(like=int(qid),
                      weights=dict(zip(spec.names, map(float, w))),
                      probes=12, k=k)
        for qid, w in zip(mut_qids, wmat)
    ]
    first = retriever.search(mut_reqs)
    again = retriever.search(mut_reqs)
    cached = sum(1 for a, b in zip(first, again) if a is b)
    print(f"[serve_retrieval] repeat batch: {cached}/{len(mut_reqs)} "
          f"responses served from the request cache")

    # ingest exact copies of the query docs: each copy is its original's
    # true nearest neighbour, so it must displace the cached answer
    new_ids = retriever.add(docs[torch.as_tensor(mut_qids, device=dev)])
    after_add = retriever.search(mut_reqs)
    hit_first = sum(1 for r, nid in zip(after_add, new_ids)
                    if r.hits and r.hits[0].doc_id == int(nid))
    if hit_first != len(mut_reqs):
        print(f"[serve_retrieval] FAIL: only {hit_first}/{len(mut_reqs)} "
              f"added copies surfaced as hit #1", file=sys.stderr)
        return 1
    print(f"[serve_retrieval] added {len(new_ids)} docs (no rebuild, "
          f"{retriever.index.n_live} live): {hit_first}/{len(mut_reqs)} "
          f"copies took over as hit #1, caches invalidated")

    removed = retriever.remove(new_ids)
    after_rm = retriever.search(mut_reqs)
    removed_set = set(map(int, new_ids))
    leaked = sum(1 for r in after_rm
                 if any(h.doc_id in removed_set for h in r.hits))
    if leaked:
        print(f"[serve_retrieval] FAIL: {leaked} removed docs leaked back "
              f"into top-k", file=sys.stderr)
        return 1
    print(f"[serve_retrieval] removed {removed} docs again: none leaked "
          f"back ({retriever.index.n_live} live) — add/remove round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quickstart: build the paper's index, run dynamically-weighted queries
through the typed retrieval API (port of ``examples/quickstart.py``)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--docs 8000] \
        [--device cpu]

On the card the FPF rounds run in the CUDA ``fpf_iter`` kernel, the
searches in ``bucket_score_tiled`` and the ground truth in ``topk_score``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import (
    Retriever, SearchRequest, brute_force_topk, competitive_recall,
    weighted_query,
)
from ..data import CorpusConfig, make_corpus
from ..kernels.common import resolve_device

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.docs

    # 1. a semi-structured corpus: title / authors / abstract vector spaces
    docs_np, spec, _ = make_corpus(CorpusConfig(n_docs=n))
    docs = torch.as_tensor(docs_np, device=dev)
    print(f"corpus: {docs.shape[0]} docs, fields {spec.names} dims "
          f"{spec.dims} on {dev}")

    # 2. ONE weight-free retriever (the paper's point: pre-processing never
    #    sees the user weights); FPF k-center clustering x3 independent
    #    clusterings (K = 90 at 8,000 docs, scaled by sqrt(n)); calibrate=
    #    fits the per-index recall->probes ladder at build so
    #    recall_target= is honest.
    k_clusters = max(16, round(90 * (n / 8000) ** 0.5))
    retriever = Retriever.build(
        docs, spec, k_clusters=k_clusters, n_clusterings=3, method="auto",
        calibrate={"n_queries": 32, "n_weight_draws": 4}, device=dev,
        generator=torch.Generator().manual_seed(0))
    print(f"search backend: {retriever.backend}")

    # 3. user requests with PER-REQUEST field weights, by field name;
    #    more-like-this requests resolve the vector from the corpus and
    #    exclude themselves; the weight embedding (paper §4) happens inside
    #    the facade.
    rng = np.random.default_rng(0)
    qids = rng.choice(n, 16, replace=False)
    wdicts = [dict(zip(spec.names, map(float, w)))
              for w in rng.dirichlet([1, 1, 1], 16)]
    requests = [SearchRequest(like=int(qid), weights=wd, k=10, probes=9)
                for qid, wd in zip(qids, wdicts)]
    responses = retriever.search(requests)

    # every hit explains itself: per-field score decomposition sums to the
    # score
    top = responses[0].hits[0]
    parts = ", ".join(f"{n_}={v:.3f}" for n_, v in top.field_scores.items())
    print(f"doc {int(qids[0])} with weights "
          f"{ {n_: round(v, 2) for n_, v in wdicts[0].items()} } -> "
          f"doc {top.doc_id} score {top.score:.3f} ({parts})")

    # 4. verify against exhaustive search (same §4 reduction, exactly)
    weights = torch.as_tensor(np.array([[wd[n_] for n_ in spec.names]
                                        for wd in wdicts], np.float32),
                              device=dev)
    qw = weighted_query(docs[torch.as_tensor(qids, device=dev)], weights,
                        spec)
    _, gt_i = brute_force_topk(docs, qw, 10, exclude=qids)
    ids = torch.as_tensor(np.stack([r.doc_ids for r in responses]),
                          device=dev)
    recall = float(competitive_recall(ids, gt_i).float().mean())
    mean_scored = float(np.mean([r.n_scored for r in responses]))
    print(f"recall@10 = {recall:.2f}/10 scanning {mean_scored / n:.1%} of "
          f"the corpus ({responses[0].backend} backend, "
          f"{responses[0].latency_s * 1e3:.1f} ms for the batch)")

    # 5. or ask for a recall level instead of a probe budget: the
    #    calibrated per-index ladder picks the budget, and the response says
    #    what recall that budget is predicted to deliver on THIS index.
    resp = retriever.search(SearchRequest(like=int(qids[0]),
                                          weights=wdicts[0], k=10,
                                          recall_target=0.9))
    print(f"recall_target=0.9 -> planner chose {resp.probes} probes "
          f"(predicted recall {resp.predicted_recall:.2f})")

    # 6. the corpus may change while serving: new documents stream into the
    #    existing buckets (no rebuild), removals tombstone out of every
    #    bucket, and the retriever's caches invalidate themselves. An exact
    #    copy of the query doc must enter at hit #1 — and leave again.
    [copy_id] = retriever.add(docs[int(qids[0])][None, :])
    resp = retriever.search(SearchRequest(like=int(qids[0]),
                                          weights=wdicts[0], k=10, probes=9))
    print(f"after add: doc {int(copy_id)} (a copy of {int(qids[0])}) is hit "
          f"#1 -> {resp.hits[0].doc_id == int(copy_id)}")
    retriever.remove([copy_id])
    resp = retriever.search(SearchRequest(like=int(qids[0]),
                                          weights=wdicts[0], k=10, probes=9))
    print(f"after remove: copy gone from the answer "
          f"-> {int(copy_id) not in resp.ids}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

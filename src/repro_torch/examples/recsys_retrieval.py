"""MIND multi-interest retrieval THROUGH the paper's typed retrieval API
(port of ``examples/recsys_retrieval.py``)::

    PYTHONPATH=src python -m repro_torch.examples.recsys_retrieval \
        [--full] [--device cpu]

MIND's serving step IS Dynamic Vector Score Aggregation: 4 interest
capsules = 4 sources of evidence, per-request interest weights = the
paper's dynamic weights. Candidate retrieval is served two ways and
compared:

* brute — the exact scores of every candidate under the §4 reduction
  (the ``topk_score`` kernel on the card);
* pruned — the paper's FPF cluster-pruned index behind a calibrated
  ``Retriever``, fed ``SearchRequest`` objects whose weights are keyed by
  interest name (``FieldSpec(i0..i3)``), at ``recall_target=0.9``.

The default is the reference's 60,000 items at E = 32 (K = 250); ``--full``
takes ``configs/mind.make_config()``: 1,000,448 items, E = 64, history 50,
K = 1,000 (sqrt(n)). The model's weights are random, made from seed 0.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..benchmarks.common import sync
from ..configs import mind as mind_config
from ..core import (
    FieldSpec, Retriever, SearchRequest, brute_force_topk,
    competitive_recall, weighted_query,
)
from ..kernels.common import resolve_device
from ..models.recsys import MIND, MINDConfig

__all__ = ["DEFAULT_CONFIG", "USERS", "TOP_K", "run", "main"]

# the reference's scaled-down candidate set (1M in the retrieval_cand cell)
DEFAULT_CONFIG = MINDConfig(n_items=60_000, embed_dim=32, n_interests=4,
                            hist_len=20)
USERS, TOP_K = 8, 10             # the requests: users, hits per request


def run(cfg: MINDConfig, k_clusters: int, *, device=None) -> dict:
    """The example's steps on ``cfg``; returns its objects (``retriever``,
    ``docs``, ``qw``, ``requests``, ``responses``) and its numbers
    (``recall`` against the brute force, as a fraction;
    ``predicted_recall``, ``probes``, ``scanned``, ``build_s``)."""
    dev = resolve_device(device)
    model = MIND(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)

    # user requests: history + per-request interest weights
    rng = np.random.default_rng(0)
    hist = torch.as_tensor(
        rng.integers(0, cfg.n_items, (USERS, cfg.hist_len)),
        dtype=torch.int32, device=dev)
    with torch.inference_mode():
        interests = model(hist)                          # (U, K, E)
    interests = interests / torch.linalg.vector_norm(interests, dim=-1,
                                                     keepdim=True)
    w = rng.dirichlet([1.0] * cfg.n_interests, USERS).astype(np.float32)

    # paper §4 reduction: weighted multi-interest -> ONE cosine query over
    # the concatenated interest spaces; candidates live replicated in each
    # subspace
    spec = FieldSpec(names=tuple(f"i{i}" for i in range(cfg.n_interests)),
                     dims=(cfg.embed_dim,) * cfg.n_interests)
    items = model.p["item_emb"].detach()
    items = items / torch.linalg.vector_norm(items, dim=-1, keepdim=True)
    docs = items.repeat(1, cfg.n_interests)              # (N, K * E)
    del items

    # brute force (exact)
    qw = weighted_query(interests.reshape(USERS, -1),
                        torch.as_tensor(w, device=dev), spec)
    _, gt_i = brute_force_topk(docs, qw, TOP_K)

    # the paper's pruned index (weight-free build!) behind the Retriever;
    # each request is a user: its interest vectors + its interest weights
    # by name. The per-index calibrated ladder (fit on THIS candidate set,
    # marginalised over weight draws) picks the budget for recall >= 0.9.
    sync(dev)
    t0 = time.perf_counter()
    retriever = Retriever.build(
        docs, spec, k_clusters, n_clusterings=3, method="auto",
        calibrate={"n_queries": 32, "n_weight_draws": 3},
        device=dev, generator=torch.Generator().manual_seed(0))
    sync(dev)
    build_s = time.perf_counter() - t0
    requests = [
        SearchRequest(
            query=[interests[u, i] for i in range(cfg.n_interests)],
            weights=dict(zip(spec.names, map(float, w[u]))),
            recall_target=0.9, k=TOP_K)
        for u in range(USERS)
    ]
    responses = retriever.search(requests)
    ids = torch.as_tensor(np.stack([r.doc_ids for r in responses]),
                          device=dev)
    recall = float(competitive_recall(ids, gt_i).float().mean()) / TOP_K
    return {
        "retriever": retriever, "docs": docs, "qw": qw, "requests": requests,
        "responses": responses, "recall": recall,
        "predicted_recall": responses[0].predicted_recall,
        "probes": responses[0].probes,
        "scanned": float(np.mean([r.n_scored for r in responses]))
        / cfg.n_items,
        "build_s": build_s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="configs/mind.make_config(): 1,000,448 items, E=64")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = mind_config.make_config() if args.full else DEFAULT_CONFIG
    k_clusters = 1_000 if args.full else 250
    out = run(cfg, k_clusters, device=args.device)
    resp = out["responses"]
    print(f"retrieval backend: {out['retriever'].backend} "
          f"({cfg.n_items} items, E = {cfg.embed_dim}, K = {k_clusters}, "
          f"build {out['build_s']:.2f} s)")
    top = resp[0].hits[0]
    mix = ", ".join(f"{n}={v:.3f}" for n, v in top.field_scores.items())
    print(f"user 0 -> item {top.doc_id}: which interest matched? {mix}")
    print(f"pruned retrieval recall@{TOP_K} = {TOP_K * out['recall']:.2f}/{TOP_K} "
          f"(target 0.9 -> {out['probes']} probes, predicted "
          f"{out['predicted_recall']:.2f}), scanning {out['scanned']:.1%} of "
          f"candidates (vs 100% for brute force)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

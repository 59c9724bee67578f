"""MIND multi-interest retrieval through the program's typed API on one card
(``repro_torch.models.recsys.MIND``, ``repro_torch.core.api.Retriever``).

Set-up builds the query encoder, MIND at the configuration's widths with
the port's initialisation from a generator of the seed. Its item table,
each row made unit and tiled once per interest (``FieldSpec(i0 .. i3)``,
the §4 reduction of per-interest weights), is the catalogue:
``Retriever.build`` builds the weight-free index on it (``fpf_fused`` from
the benchmark's FPF draws, one medoid adjustment, the fp32 bucket-major
pack) and calibrates its probe ladder. Traffic entries (:data:`ENTRIES`;
any other is refused):

``Retriever.search``
    batches of users in a closed loop: the batch's histories through MIND,
    its interests made unit, one ``SearchRequest`` a user with its
    interests as the per-field query and its interest weights by name, at
    the traffic's ``recall_target`` and ``k``; each batch's ids and scores
    copied into host buffers before the next.

Serving and calibration both run the ``fused`` backend, named: the
program's ``pick_backend`` answers ``sharded`` wherever more than one card
is visible, which would time another path under this cell's name.

The check follows each stage from the program's own inputs: MIND's
interests against the plain reference's for the checked batches'
histories (``tower_err``); the index as ``cluster_prune`` checks it,
through the same FPF hook; each checked batch's answers, judged at the
probes its responses report, for the program's own interests and weights;
the per-interest scores of every hit of the first and the last step
(``field_err``); and the traffic's ``recall_target`` over the recall@k
the checked users got against the reference's exact top ``k``, less three
sampling errors of their mean (``recall_gap``): the recall each request
asks for, not the planner's own forecast of it.

The control rounds the item table to TF32 (10-bit mantissas) before the
program sees it, in MIND and in the catalogue made from it; the reference
keeps the fp32 table.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from .. import datagen
from ..reference import index_ref, mind_ref, search_ref
from . import LOOPS, choose, refuse_unknown
from .cluster_prune import METHODS, PACK_DTYPES
from .cluster_prune import System as ClusterPrune


def history_batch(n_items: int, batch: int, hist_len: int, *, step: int,
                  seed: int) -> np.ndarray:
    """``(batch, hist_len)`` int32 histories: the yardstick's own copy of
    ``repro_torch.data.recsys_data.history_batch``'s, bit for bit (70 % of
    each history from the user's preferred item cluster, the rest
    log-uniform over the catalogue), without its targets and labels."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**63, step, 0, 7]))
    n_clusters = 50
    pref = rng.integers(0, n_clusters, batch)
    from_pref = rng.random((batch, hist_len)) < 0.7
    u = rng.random((batch, hist_len))
    rand = np.clip(np.exp(u * np.log(n_items)).astype(np.int64) - 1, 0,
                   n_items - 1)
    in_pref = np.clip((rand // n_clusters) * n_clusters + pref[:, None], 0,
                      n_items - 1)
    return np.where(from_pref, in_pref, rand).astype(np.int32)


ENTRIES = {"Retriever.search": "api"}
USERS = {"history_batch": history_batch}
# the backend the cell times, for serving and for calibration
BACKENDS = {"fused": "fused"}
CONFIG_KEYS = {"n_items", "embed_dim", "n_interests", "capsule_iters",
               "hist_len", "n_clusterings", "k_clusters", "method",
               "refine_iters", "pack_dtype", "backend", "calibrate",
               "fpf_hook", "check"}
CALIBRATE_KEYS = {"n_queries", "n_weight_draws"}
TRAFFIC_KEYS = {"entry", "loop", "users", "batch", "alpha", "recall_target",
                "k", "pool_batches", "warmup_batches"}

_MODEL_STREAM = 6
_WEIGHT_STREAM = 3
_WARMUP_STREAM = 5
_CHECK_ROWS = 128          # queries the check scores against every row at once
_RECALL_ERRS = 3           # sampling errors of the checked users' recall allowed


class System(ClusterPrune):
    """Shares ``cluster_prune``'s FPF hook and index check; everything else
    is its own."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev,
                 control: bool = False):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.control = control
        refuse_unknown(cfg, CONFIG_KEYS, "configuration")
        refuse_unknown(cfg["calibrate"], CALIBRATE_KEYS,
                       "configuration's calibrate")
        self.method = choose(cfg, "method", METHODS, "configuration")
        self.pack_dtype = choose(cfg, "pack_dtype", PACK_DTYPES,
                                 "configuration")
        self.backend = choose(cfg, "backend", BACKENDS, "configuration")
        self.kind = choose(traffic, "entry", ENTRIES, "traffic")
        refuse_unknown(traffic, TRAFFIC_KEYS, "traffic")
        choose(traffic, "loop", LOOPS, "traffic")
        self.histories = choose(traffic, "users", USERS, "traffic")
        self.n = int(cfg["n_items"])
        self.n_fields = int(cfg["n_interests"])
        self.dims = [int(cfg["embed_dim"])] * self.n_fields
        self.names = tuple(f"i{f}" for f in range(self.n_fields))
        self.centres = []
        self.index = None

    # ----------------------------------------------------------- set-up
    def setup(self):
        from repro_torch.core.api import Retriever
        from repro_torch.core.fields import FieldSpec
        from repro_torch.models.recsys import MIND, MINDConfig

        cfg, dev = self.cfg, self.dev
        if int(cfg["refine_iters"]) != 1:
            raise ValueError("the index check holds leaders to one medoid "
                             "adjustment: refine_iters must be 1")
        mcfg = MINDConfig(
            name="mind", n_items=self.n, embed_dim=int(cfg["embed_dim"]),
            n_interests=self.n_fields,
            capsule_iters=int(cfg["capsule_iters"]),
            hist_len=int(cfg["hist_len"]))
        self.model = MIND(mcfg, generator=datagen.generator(
            self.seed, _MODEL_STREAM, dev), device=dev)
        table = self.model.p["item_emb"].detach()
        # the reference's copies of the program's inputs, taken before the
        # control rounds the program's table
        self.ref = {"item_emb": table.clone(),
                    "bilinear": self.model.p["bilinear"].detach().clone(),
                    "routing_logits": self.model.routing_logits.clone()}
        self.docs = mind_ref.item_docs(self.ref["item_emb"], self.n_fields)
        self.prog_docs = self.docs
        if self.control:
            table.copy_(datagen.round_to_tf32(table))
            self.prog_docs = mind_ref.item_docs(table, self.n_fields)

        self._capture_centres()
        t_cl, kc = int(cfg["n_clusterings"]), int(cfg["k_clusters"])
        m = int(np.ceil(np.sqrt(np.float32(kc * self.n), dtype=np.float32)))
        self.last_draws = datagen.build_draws(self.n, m, t_cl, 1, self.seed,
                                              dev)[0]
        self.centres.clear()
        self.retriever = Retriever.build(
            self.prog_docs, FieldSpec(names=self.names, dims=tuple(self.dims)),
            kc, n_clusterings=t_cl, method=self.method, pack_major=True,
            pack_dtype=self.pack_dtype, draws=self.last_draws, device=dev,
            refine_iters=int(cfg["refine_iters"]), backend=self.backend,
            calibrate={**cfg["calibrate"], "backend": self.backend})
        self.index = self.retriever.index

        tr = self.traffic
        b, k, pool = int(tr["batch"]), int(tr["k"]), int(tr["pool_batches"])
        self.hist, self.w, self.w_host = self._pool(pool, self.seed)
        # the window's interests, one row a pool batch (the check's and the
        # work count's inputs), and its answers on the host
        self.raw = torch.empty((pool, b, self.n_fields, self.dims[0]),
                               device=dev)
        self.host = (np.empty((pool, b, k), np.float32),
                     np.empty((pool, b, k), np.int32))
        self.first = self.last = None
        warm = int(tr["warmup_batches"])
        hist, _, w_host = self._pool(warm, self.seed * 7 + _WARMUP_STREAM)
        for i in range(warm):
            self._serve(hist[i], w_host[i], self.raw[i % pool])
        self._sync()
        # what set-up left on the heap stays out of the window's garbage
        # collections, as a serving process freezes its start-up objects
        gc.collect()
        gc.freeze()

    def _pool(self, n_batches: int, seed: int):
        """``n_batches`` batches of users: histories ``(n, B, L)`` and
        interest weights ``(n, B, K)`` on the card, and the weights' host
        copy, from which each step names them per request."""
        tr = self.traffic
        b, hl = int(tr["batch"]), int(self.cfg["hist_len"])
        hist = np.stack([self.histories(self.n, b, hl, step=j, seed=seed)
                         for j in range(n_batches)])
        g = datagen.generator(seed, _WEIGHT_STREAM, self.dev)
        w = datagen.dirichlet(tr["alpha"], n_batches * b, g, self.dev
                              ).reshape(n_batches, b, self.n_fields)
        return torch.as_tensor(hist, device=self.dev), w, w.cpu().numpy()

    # ----------------------------------------------------------- window
    def _serve(self, hist, w_host, raw):
        """One batch through the program: MIND, then ``Retriever.search``
        with each user's weights by interest name; the interests are kept
        in ``raw``."""
        from repro_torch.core.api import SearchRequest

        tr = self.traffic
        with torch.inference_mode():
            v = self.model(hist)
            raw.copy_(v)
            unit = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        target, k = float(tr["recall_target"]), int(tr["k"])
        return self.retriever.search([
            SearchRequest(query=list(user.unbind()),
                          weights=dict(zip(self.names, wu)),
                          recall_target=target, k=k)
            for user, wu in zip(unit.unbind(), w_host.tolist())])

    def run_once(self, i: int, label):
        """Window step ``i``: one batch of users, its answers on the host;
        the first and the latest step's responses are kept whole."""
        j = i % self.hist.shape[0]
        with label("bench.search"):
            resps = self._serve(self.hist[j], self.w_host[j], self.raw[j])
        with label("bench.to_host"):
            np.stack([r.scores for r in resps], out=self.host[0][j])
            np.stack([r.doc_ids for r in resps], out=self.host[1][j])
            probes = np.fromiter((r.probes for r in resps), np.int64,
                                 len(resps))
        if i == 0:
            self.first = (j, resps)
        self.last = (j, resps)
        return j, probes

    def _unit_queries(self, j: int) -> torch.Tensor:
        """``(B, D)`` weighted queries of pool batch ``j``, from the
        program's interests as the window made them unit."""
        v = self.raw[j]
        unit = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return search_ref.weighted_query(unit.reshape(unit.shape[0], -1),
                                         self.w[j], self.dims)

    # ------------------------------------------------------------ check
    def check(self, results: dict, pick: np.ndarray) -> dict:
        out = {"tower_err": self._check_tower(results, pick)}
        out.update(self._check_index())
        out.update(self._check_answers(results, pick))
        out["field_err"] = self._check_fields()
        return out

    def _check_tower(self, results, pick) -> float:
        worst = 0.0
        for i in pick:
            j = results[int(i)][0]
            ref = mind_ref.mind_forward(
                self.ref["item_emb"], self.ref["bilinear"],
                self.ref["routing_logits"], self.hist[j],
                int(self.cfg["capsule_iters"]))
            worst = max(worst, float((self.raw[j] - ref).abs().max()))
        return worst

    def _check_answers(self, results, pick) -> dict:
        idx = self.index
        eps = float(self.cfg["check"]["ambiguity_eps"])
        t_cl, kc = idx.leaders.shape[:2]
        leaders = idx.leaders.reshape(t_cl * kc, -1)
        worst = {"bad_answers": 0, "score_err": 0.0, "rank_gap": 0.0}
        recalls = []
        # a pool batch picked twice is one set of users, checked once
        for j, probes in dict(results[int(i)] for i in pick).items():
            qw_all = self._unit_queries(j)
            s_all = torch.as_tensor(self.host[0][j], device=self.dev)
            ids_all = torch.as_tensor(self.host[1][j], device=self.dev)
            for lo in range(0, qw_all.shape[0], _CHECK_ROWS):
                sl = slice(lo, lo + _CHECK_ROWS)
                qw, s, ids = qw_all[sl], s_all[sl], ids_all[sl]
                with index_ref.exact_fp32():
                    sims = (qw @ leaders.T).reshape(-1, t_cl, kc)
                certain = torch.zeros_like(sims, dtype=torch.bool)
                possible = torch.zeros_like(certain)
                p_rows = torch.as_tensor(probes[sl], device=self.dev)
                for p in np.unique(probes[sl]):
                    rows = p_rows == int(p)
                    c, q = search_ref.probe_sets(
                        sims[rows], search_ref.split_probes(int(p), t_cl), eps)
                    certain[rows], possible[rows] = c, q
                full = search_ref.full_scores(qw, self.docs)
                r = search_ref.judge(
                    full, s, ids,
                    search_ref.member_mask(certain, idx.buckets, self.n),
                    search_ref.member_mask(possible, idx.buckets, self.n),
                    torch.full((qw.shape[0],), -1, device=self.dev))
                worst["bad_answers"] += r["bad"]
                worst["score_err"] = max(worst["score_err"], r["score_err"])
                worst["rank_gap"] = max(worst["rank_gap"], r["rank_gap"])
                recalls.append(mind_ref.recall_per_query(ids, full).cpu())
                del full
        recalls = torch.cat(recalls)
        achieved = float(recalls.mean())
        # the sampling error of the checked users' mean
        err = float(recalls.std()) / len(recalls) ** 0.5
        target = float(self.traffic["recall_target"])
        print(f"perfbench: recall@{ids_all.shape[1]} asked {target:.6f}"
              f" achieved {achieved:.6f} +- {err:.6f} over {len(recalls)}"
              " users", file=sys.stderr)
        worst["recall_gap"] = target - achieved - _RECALL_ERRS * err
        return worst

    def _check_fields(self) -> float:
        """The widest gap between a kept hit's per-interest score and the
        reference's, or between their sum and the hit's score; a hit that
        is not its response's answer, or that names other interests, reads
        ``inf``."""
        worst = 0.0
        for j, resps in (self.first, self.last):
            qw = self._unit_queries(j)
            k = int(self.traffic["k"])
            ids = torch.full((len(resps), k), -1, dtype=torch.long)
            got = torch.zeros((len(resps), k, self.n_fields),
                              dtype=torch.float64)
            score = torch.zeros((len(resps), k), dtype=torch.float64)
            for u, r in enumerate(resps):
                want = [int(x) for x in r.doc_ids if x >= 0]
                if [h.doc_id for h in r.hits] != want:
                    return float("inf")
                for c, h in enumerate(r.hits):
                    if tuple(h.field_scores) != self.names:
                        return float("inf")
                    ids[u, c] = h.doc_id
                    got[u, c] = torch.tensor(list(h.field_scores.values()),
                                             dtype=torch.float64)
                    score[u, c] = h.score
            ref = mind_ref.field_scores(qw, self.docs, ids.to(self.dev),
                                        self.dims).double().cpu()
            live = (ids >= 0)[..., None]
            worst = max(worst,
                        float(((got - ref).abs() * live).max()),
                        float(((got.sum(-1) - score).abs()
                               * live[..., 0]).max()))
        return worst

    # ------------------------------------------------------- work counts
    def work(self, n_steps: int) -> dict:
        """The work the window's ``n_steps`` steps needed, from the
        algorithm and the inputs (the reference's navigation of each pool
        batch's queries at the probes served), never from what a kernel
        did: ``{"kernel": {"bucket_score_tiled": work}, "step": work}``."""
        idx, tr = self.index, self.traffic
        d, n = sum(self.dims), self.n
        t_cl, kc = idx.leaders.shape[:2]
        b, k = int(tr["batch"]), int(tr["k"])
        pool = self.hist.shape[0]
        probes_t = search_ref.split_probes(int(self.last[1][0].probes), t_cl)
        rows = pairs = 0
        for j in range(min(pool, n_steps)):
            uses = n_steps // pool + (j < n_steps % pool)
            got = search_ref.probe_work(self._unit_queries(j), idx.leaders,
                                        idx.buckets, idx.counts, probes_t, n,
                                        b)
            rows += uses * int(got[0])
            pairs += uses * int(got[2])
        io = n_steps * (b * d * 4 + b * k * 8)
        kern = {"bytes": float(rows * d * 4 + io),
                "flops": {"fp32": float(2 * d * pairs)}}
        e, hl = self.dims[0], int(self.cfg["hist_len"])
        iters = int(self.cfg["capsule_iters"])
        # MIND: the histories' rows and the bilinear map read once, the
        # interests written; the map, and each round's weighted sums and
        # (but the last) agreements
        tower_bytes = n_steps * (b * hl * (e + 1) * 4
                                 + b * self.n_fields * e * 4 + e * e * 4)
        tower_flops = n_steps * (2 * b * hl * e * e + (2 * iters - 1) * 2
                                 * b * self.n_fields * hl * e)
        step = {"bytes": float(n_steps * t_cl * kc * d * 4 + rows * d * 4
                               + io + tower_bytes),
                "flops": {"fp32": float(n_steps * 2 * b * t_cl * kc * d
                                        + 2 * d * pairs + tower_flops)}}
        return {"kernel": {"bucket_score_tiled": kern}, "step": step}


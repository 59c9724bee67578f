"""Rank 0's program of the paper's production deployment
(``repro_torch.configs.paper_retrieval``) on one card.

Set-up draws the rank's clustered shard from the seed. Traffic entries
(:data:`ENTRIES`; any other is refused):

``serve_online_rank``
    set-up builds the replicated leaders as the deployment does: for each
    clustering, FPF through the program's ``fpf_centers_fused`` on its own
    ``ceil(sqrt(K n))``-row sample, the assignment by
    ``build_assign_rank``, and the rank's local buckets
    (``build_local_buckets``) cut at ``bucket_pad`` by ``pad_buckets``;
    each batch then runs ``serve_online_rank``.
``serve_brute_rank``
    set-up makes the shard only; each batch runs ``serve_brute_rank``.

Each window batch forms its weighted queries with ``weighted_query`` (fp32,
then the serving dtype), runs its entry, then ``gather_merge`` over a group
of one; its ids and scores are copied to the host before the next. The
traffic's ``probes`` and ``k`` default to the configuration's.

The control run rounds the shard through fp8 (e4m3) before the program
sees it, the precision below the bf16 the configuration states; the
reference keeps the bf16 shard.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import datagen
from ..reference import index_ref, search_ref
from . import SearchLoop, choose, refuse_unknown

ENTRIES = {"serve_online_rank": "online", "serve_brute_rank": "brute"}
CORPORA = {"clustered_topics": datagen.clustered_shard}
# the serving dtype; the control's fp8 rounding and the brute-force check's
# bf16 score spacing are this dtype's
DTYPES = {"bfloat16": torch.bfloat16}
CONFIG_KEYS = {"corpus", "n_docs", "n_rows", "field_names", "field_dims",
               "n_topics", "noise", "chunk_rows", "n_clusterings",
               "k_clusters", "bucket_pad", "probes", "k", "dtype", "check"}


class System(SearchLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev,
                 control: bool = False):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.control = control
        refuse_unknown(cfg, CONFIG_KEYS, "configuration")
        self.make_shard = choose(cfg, "corpus", CORPORA, "configuration")
        self.dtype = choose(cfg, "dtype", DTYPES, "configuration")
        self.mode = choose(traffic, "entry", ENTRIES, "traffic")
        self._check_search_traffic({"probes"})
        self.dims = list(cfg["field_dims"])
        self.n = int(cfg["n_rows"])
        if self.n != int(cfg["n_docs"]):
            raise ValueError("one chip holds the whole (reduced) corpus: "
                             "n_rows must equal n_docs")
        self.t_cl = int(cfg["n_clusterings"])
        self.kc = int(cfg["k_clusters"])
        self.probes = int(traffic.get("probes", cfg["probes"]))
        self.k = int(traffic.get("k", cfg["k"]))

    def setup(self):
        from repro_torch.configs import paper_retrieval as TP
        from repro_torch.core.distributed import build_local_buckets
        from repro_torch.core.fields import FieldSpec
        from repro_torch.kernels.fpf_iter import fpf_centers_fused

        self.spec = FieldSpec(names=tuple(self.cfg["field_names"]),
                              dims=tuple(self.dims))
        self.docs = self.make_shard(self.cfg, self.seed, self.dev,
                                    dtype=self.dtype)
        self.prog_docs = self.docs
        if self.control:
            self.prog_docs = self.docs.to(torch.float8_e4m3fn).to(
                self.docs.dtype)
        if self.mode == "online":
            m = int(np.ceil(np.sqrt(np.float32(self.kc * self.n),
                                    dtype=np.float32)))
            self.draws = datagen.build_draws(self.n, m, self.t_cl, 1,
                                             self.seed, self.dev)[0]
            leaders = torch.empty((self.t_cl, self.kc, sum(self.dims)),
                                  dtype=self.docs.dtype, device=self.dev)
            self.centres = []
            for t, draw in enumerate(self.draws):
                sample = draw["sample_idx"].to(self.dev)
                xs = self.prog_docs[sample].float().contiguous()
                c = fpf_centers_fused(xs, self.kc, draw["first"])
                self.centres.append(c)
                leaders[t] = self.prog_docs[sample[c.long()]]
                del xs
            self.leaders = leaders
            self.assign = torch.stack([
                TP.build_assign_rank(self.prog_docs, leaders[t])
                for t in range(self.t_cl)])
            bkt = build_local_buckets(self.assign.cpu().numpy(), self.n, 1,
                                      self.kc)
            bkt, self.dropped = TP.pad_buckets(
                torch.as_tensor(bkt), int(self.cfg["bucket_pad"]), self.n)
            self.buckets = bkt[0].to(self.dev)
        self._draw_and_warm()

    def _search(self, like, w):
        from repro_torch.configs import paper_retrieval as TP
        from repro_torch.core.weights import weighted_query

        qw = weighted_query(self.prog_docs[like].float(), w, self.spec).to(
            self.prog_docs.dtype)
        ex = like.to(torch.int32)
        if self.mode == "online":
            s, i = TP.serve_online_rank(
                self.prog_docs, self.leaders, self.buckets, qw,
                probes_t=TP.split_probes(self.probes, self.t_cl), k=self.k,
                offset=0, exclude=ex)
        else:
            s, i = TP.serve_brute_rank(self.prog_docs, qw, k=self.k,
                                       offset=0, n_valid=self.n, exclude=ex)
        return TP.gather_merge(s, i, self.k)

    # ------------------------------------------------------------ check
    def check(self, results: dict, pick: np.ndarray) -> dict:
        out = {}
        if self.mode == "online":
            out.update(self._check_leaders())
        out.update(self._check_answers(results, pick))
        return out

    def _check_leaders(self) -> dict:
        """FPF round by round on the program's centres, the assignment to
        the program's leaders, and the buckets the assignment defines."""
        fpf, asg, mism = 0.0, 0.0, 0
        for t, draw in enumerate(self.draws):
            sample = draw["sample_idx"].to(self.dev)
            c = self.centres[t].long()
            if c.numel() != self.kc or bool(
                    ((c < 0) | (c >= sample.numel())).any()):
                mism += 10**6
                continue
            mism += int(int(c[0]) != int(draw["first"]))
            fpf = max(fpf, float(index_ref.fpf_round_gaps(
                self.docs[sample], c).max()))
            mism += int((self.leaders[t] != self.docs[sample[c]]).any(1)
                        .sum())
            asg = max(asg, index_ref.assign_gap(self.docs, self.leaders[t],
                                                self.assign[t]))
            mism += index_ref.bucket_mismatches(self.assign[t],
                                                self.buckets[t], None, self.n)
        return {"fpf_gap": fpf, "assign_gap": asg, "index_mismatch": mism}

    def _check_answers(self, results: dict, pick) -> dict:
        brute = self.mode == "brute"
        keys = (("bad", "far_scores", "far_ranks", "score_off") if brute
                else ("bad", "score_err", "rank_gap"))
        worst = dict.fromkeys(keys, 0)
        all_rows = None
        for i in pick:
            like, w = datagen.pool_batch(self.pool, int(i))
            s, ids = results[int(i)]
            qw = search_ref.weighted_query(self.docs[like], w, self.dims).to(
                self.docs.dtype)
            scores = search_ref.full_scores(qw, self.docs)
            if brute:
                scores = scores.to(torch.bfloat16).float()
                if all_rows is None:
                    all_rows = torch.ones_like(scores, dtype=torch.bool)
                certain = possible = all_rows
            else:
                t_cl, kc = self.t_cl, self.kc
                with index_ref.exact_fp32():
                    sims = (qw.float() @ self.leaders.reshape(
                        t_cl * kc, -1).float().T).to(torch.bfloat16).float()
                sims = sims.reshape(-1, t_cl, kc)
                probes_t = search_ref.split_probes(self.probes, t_cl)
                c_set, p_set = search_ref.probe_sets(
                    sims, probes_t, search_ref.bf16_ulp(sims).float())
                certain = search_ref.member_mask(c_set, self.buckets, self.n)
                possible = search_ref.member_mask(p_set, self.buckets,
                                                  self.n)
            r = search_ref.judge(scores, s, ids, certain, possible, like,
                                 ulps=brute)
            for key in keys:
                worst[key] = (worst[key] + r[key]
                              if key in ("bad", "far_scores", "far_ranks")
                              else max(worst[key], r[key]))
        worst["bad_answers"] = worst.pop("bad")
        return worst

    # ------------------------------------------------------- work counts
    def work(self, n_steps: int) -> dict:
        d, n = sum(self.dims), self.n
        nq, k = int(self.traffic["batch"]), self.k
        io = nq * d * 2 + nq * k * 8
        if self.mode == "brute":
            one = {"bytes": float(n * d * 2 + io),
                   "flops": {"bf16": float(2 * nq * n * d)}}
            w = {"bytes": one["bytes"] * n_steps,
                 "flops": {"bf16": one["flops"]["bf16"] * n_steps}}
            return {"kernel": {"topk_score": w}, "step": w}
        t_cl, kc = self.t_cl, self.kc
        probes_t = search_ref.split_probes(self.probes, t_cl)
        _, rows, pairs = self._navigated(n_steps, self.leaders, self.buckets,
                                         None, probes_t)
        step = {"bytes": float(n_steps * (t_cl * kc * d * 2 + io)
                               + rows * d * 2),
                "flops": {"bf16": float(n_steps * 2 * nq * t_cl * kc * d
                                        + 2 * d * pairs)}}
        return {"kernel": {}, "step": step}

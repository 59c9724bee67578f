"""The paper's cluster-pruned index on one card (``repro_torch.core.index``).

Set-up draws the corpus from the seed, hands the program the FPF draws
(each clustering's sample and first centre) and lets it build
``ClusterPruneIndex`` (``fpf_fused``: the ``fpf_iter`` kernel, then the
assignment and the medoid adjustment, bucket packing and the fp32
bucket-major pack). Traffic entries (:data:`ENTRIES`; any other is
refused):

``ClusterPruneIndex.search_weighted``
    batches of more-like-this queries through
    ``search_weighted(..., backend="fused")`` (the engine's navigation and
    probe schedule, then ``bucket_score_tiled``), each batch's ids and
    scores copied to the host before the next.
``ClusterPruneIndex.build``
    back-to-back builds, each from fresh draws, the previous index freed
    first; a build counts when its pack is on the card.

The FPF centres are read where the program makes them: the configuration's
``fpf_hook`` names the program's kernel entry
(``repro_torch.kernels.fpf_iter.fpf_centers_fused``), which the driver
wraps to record each clustering's centres; the medoid adjustment replaces
them in the index, and the check follows them round by round. This is a
hook the program has to keep: a build that does not reach it reads as not
correct, with a message that names the hook. The wrapper only appends the
centres to a list, in the timed builds too.

The control run rounds the corpus to TF32 (10-bit mantissas) before the
program sees it, so that its fp32 arithmetic computes what TF32 would, the
precision below the fp32 the configuration states; the reference keeps the
fp32 corpus.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np
import torch

from .. import datagen
from ..reference import index_ref, search_ref
from . import SearchLoop, choose, refuse_unknown

ENTRIES = {"ClusterPruneIndex.search_weighted": "search",
           "ClusterPruneIndex.build": "build"}
BUILD_LOOPS = {"back_to_back": "one build after another, the previous "
                               "index freed first"}
CORPORA = {"citeseer_topics": datagen.citeseer_corpus}
# the check follows the FPF centres through the hook and holds the pack to
# the fp32 rows: other methods and pack dtypes need checks of their own
METHODS = {"fpf_fused": "fpf_fused"}
PACK_DTYPES = {"float32": "float32"}
CONFIG_KEYS = {"corpus", "n_docs", "field_names", "field_dims", "vocab_sizes",
               "terms_per_field", "n_topics", "salient_per_topic",
               "topic_mix_alpha", "noise_terms", "n_clusterings",
               "k_clusters", "method", "refine_iters", "pack_dtype",
               "fpf_hook", "check"}


class System(SearchLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev,
                 control: bool = False):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.control = control
        refuse_unknown(cfg, CONFIG_KEYS, "configuration")
        self.make_corpus = choose(cfg, "corpus", CORPORA, "configuration")
        self.method = choose(cfg, "method", METHODS, "configuration")
        self.pack_dtype = choose(cfg, "pack_dtype", PACK_DTYPES,
                                 "configuration")
        self.kind = choose(traffic, "entry", ENTRIES, "traffic")
        if self.kind == "search":
            self._check_search_traffic({"probes"})
        else:
            refuse_unknown(traffic, {"entry", "loop", "max_builds"},
                           "traffic")
            choose(traffic, "loop", BUILD_LOOPS, "traffic")
        self.dims = list(cfg["field_dims"])
        self.n = int(cfg["n_docs"])
        self.centres = []
        self.index = None

    # ----------------------------------------------------------- set-up
    def _capture_centres(self):
        """Wrap the program's FPF entry that ``fpf_hook`` names so that it
        records each clustering's centres in ``self.centres``."""
        module, name = self.cfg["fpf_hook"].rsplit(".", 1)
        # the module object itself: ``repro_torch.kernels`` shadows its
        # ``fpf_iter`` subpackage with a function of that name
        importlib.import_module(module)
        mod = sys.modules[module]
        fn = getattr(mod, name)
        if getattr(fn, "_bench_wrapped", False):
            fn._bench_sink = self.centres
            return
        inner = fn

        def recording(x, k, first):
            out = inner(x, k, first)
            recording._bench_sink.append(out)
            return out

        recording._bench_wrapped = True
        recording._bench_sink = self.centres
        setattr(mod, name, recording)

    def _build(self, draws):
        from repro_torch.core.fields import FieldSpec
        from repro_torch.core.index import ClusterPruneIndex

        spec = FieldSpec(names=tuple(self.cfg["field_names"]),
                         dims=tuple(self.dims))
        self.centres.clear()
        return ClusterPruneIndex.build(
            self.prog_docs, spec, int(self.cfg["k_clusters"]),
            n_clusterings=int(self.cfg["n_clusterings"]),
            method=self.method, pack_major=True, pack_dtype=self.pack_dtype,
            draws=draws, device=self.dev,
            refine_iters=int(self.cfg["refine_iters"]))

    def setup(self):
        cfg = self.cfg
        if int(cfg["refine_iters"]) != 1:
            raise ValueError("the index check holds leaders to one medoid "
                             "adjustment: refine_iters must be 1")
        self.docs = self.make_corpus(cfg, self.seed, self.dev)
        self.prog_docs = (datagen.round_to_tf32(self.docs) if self.control
                          else self.docs)
        self._capture_centres()
        t_cl = int(cfg["n_clusterings"])
        m = int(np.ceil(np.sqrt(np.float32(int(cfg["k_clusters"]) * self.n),
                                dtype=np.float32)))
        self.sample = m
        if self.kind == "build":
            self.n_draws = int(self.traffic["max_builds"])
            self.draws = datagen.build_draws(self.n, m, t_cl,
                                             self.n_draws + 1, self.seed,
                                             self.dev)
            self.index = self._build(self.draws[-1])     # the warm-up build
            self._sync()
            self.last_draws = self.draws[-1]
            return
        self.last_draws = datagen.build_draws(self.n, m, t_cl, 1, self.seed,
                                              self.dev)[0]
        self.index = self._build(self.last_draws)
        self._draw_and_warm()

    # ----------------------------------------------------------- window
    def _search(self, like, w):
        tr = self.traffic
        s, ids, _ = self.index.search_weighted(
            self.prog_docs[like], w, probes=int(tr["probes"]),
            k=int(tr["k"]), exclude=like, backend="fused")
        return s, ids

    def queries_per_step(self) -> int:
        return 1 if self.kind == "build" else super().queries_per_step()

    def run_once(self, i: int, label):
        """Step ``i`` of the window; its result on the host."""
        if self.kind == "search":
            return super().run_once(i, label)
        with label("bench.free"):
            self.index = None
        with label("bench.build"):
            self.index = self._build(self.draws[i % self.n_draws])
        with label("bench.sync"):
            self._sync()
        self.last_draws = self.draws[i % self.n_draws]
        return None

    # ------------------------------------------------------------ check
    def check(self, results: dict, pick: np.ndarray) -> dict:
        """The numbers compared: the index's (FPF, medoid, assignment,
        buckets, pack), and for ``search`` the answers of the batches
        ``pick``."""
        out = self._check_index()
        if self.kind == "search":
            out.update(self._check_answers(results, pick))
        return out

    def _check_index(self) -> dict:
        idx, n = self.index, self.n
        eps = float(self.cfg["check"]["ambiguity_eps"])
        if len(self.centres) != int(self.cfg["n_clusterings"]):
            print(f"perfbench: the last build reached the program's FPF "
                  f"entry {self.cfg['fpf_hook']} {len(self.centres)} times, "
                  f"not once a clustering: the index check cannot follow "
                  f"its centres (the configuration's fpf_hook)",
                  file=sys.stderr)
            return {"fpf_gap": float("inf"), "medoid_gap": float("inf"),
                    "assign_gap": float("inf"),
                    "index_mismatch": 10**9}
        fpf, med, asg, mism = 0.0, 0.0, 0.0, 0
        assign = torch.as_tensor(idx.assign, device=self.dev)
        for t, draw in enumerate(self.last_draws):
            sample = torch.as_tensor(draw["sample_idx"], device=self.dev)
            c = self.centres[t].to(self.dev).long()
            if c.numel() != idx.leaders.shape[1] or bool(
                    ((c < 0) | (c >= sample.numel())).any()):
                mism += 10**6
                continue
            mism += int(int(c[0]) != int(draw["first"]))
            x = self.docs[sample]
            fpf = max(fpf, float(index_ref.fpf_round_gaps(x, c).max()))
            g, not_member = index_ref.medoid_gap(
                self.docs, x[c], idx.leaders[t], eps=eps)
            med = max(med, g)
            mism += not_member
            asg = max(asg, index_ref.assign_gap(self.docs, idx.leaders[t],
                                                assign[t]))
            mism += index_ref.bucket_mismatches(assign[t], idx.buckets[t],
                                                idx.counts[t], n)
            del x
        data, ids, _ = idx.ensure_bucket_major()
        mism += index_ref.pack_mismatches(self.docs, data, ids, idx.buckets,
                                          n)
        return {"fpf_gap": fpf, "medoid_gap": med, "assign_gap": asg,
                "index_mismatch": mism}

    def _check_answers(self, results: dict, pick) -> dict:
        tr, idx = self.traffic, self.index
        eps = float(self.cfg["check"]["ambiguity_eps"])
        t_cl, kc = idx.leaders.shape[:2]
        probes_t = search_ref.split_probes(int(tr["probes"]), t_cl)
        worst = {"bad_answers": 0, "score_err": 0.0, "rank_gap": 0.0}
        for i in pick:
            like, w = datagen.pool_batch(self.pool, int(i))
            s, ids = results[int(i)]
            qw = search_ref.weighted_query(self.docs[like], w, self.dims)
            with index_ref.exact_fp32():
                sims = (qw @ idx.leaders.reshape(t_cl * kc, -1).T
                        ).reshape(-1, t_cl, kc)
            certain, possible = search_ref.probe_sets(sims, probes_t, eps)
            r = search_ref.judge(
                search_ref.full_scores(qw, self.docs), s, ids,
                search_ref.member_mask(certain, idx.buckets, self.n),
                search_ref.member_mask(possible, idx.buckets, self.n), like)
            worst["bad_answers"] += r["bad"]
            worst["score_err"] = max(worst["score_err"], r["score_err"])
            worst["rank_gap"] = max(worst["rank_gap"], r["rank_gap"])
        return worst

    # ------------------------------------------------------- work counts
    def work(self, n_steps: int) -> dict:
        """The work the window's ``n_steps`` steps needed, from the
        algorithm and the inputs (the reference's navigation), never from
        what a kernel did: ``{"kernel": {name: work}, "step": work}`` with
        ``work = {"bytes": .., "flops": {dtype: ..}}`` summed over the
        steps."""
        d, n = sum(self.dims), self.n
        t_cl, kc = int(self.cfg["n_clusterings"]), int(self.cfg["k_clusters"])
        if self.kind == "build":
            m, rounds = self.sample, kc - 1
            fpf = {"bytes": float(t_cl * m * d * 4),
                   "flops": {"fp32": float(t_cl * rounds * 2 * m * d)}}
            passes = 1 + int(self.cfg["refine_iters"])
            step = {"bytes": float(n * d * 4 + t_cl * n * d * 4),
                    "flops": {"fp32": fpf["flops"]["fp32"]
                              + float(passes * 2 * n * t_cl * kc * d)}}
            return {"kernel": {"fpf_iter": _times(fpf, n_steps)},
                    "step": _times(step, n_steps)}
        tr, idx = self.traffic, self.index
        nq, k = int(tr["batch"]), int(tr["k"])
        probes_t = search_ref.split_probes(int(tr["probes"]), t_cl)
        rows, _, pairs = self._navigated(n_steps, idx.leaders, idx.buckets,
                                         idx.counts, probes_t)
        io = n_steps * (nq * d * 4 + nq * k * 8)
        kern = {"bytes": float(rows * d * 4 + io),
                "flops": {"fp32": float(2 * d * pairs)}}
        step = {"bytes": float(n_steps * t_cl * kc * d * 4 + rows * d * 4
                               + io),
                "flops": {"fp32": float(n_steps * 2 * nq * t_cl * kc * d
                                        + 2 * d * pairs)}}
        return {"kernel": {"bucket_score_tiled": kern}, "step": step}


def _times(work: dict, n: int) -> dict:
    return {"bytes": work["bytes"] * n,
            "flops": {k: v * n for k, v in work["flops"].items()}}

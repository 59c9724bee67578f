"""The port's rank-local programs on DTensors (``repro_torch.runtime.spmd``
and the sharded paths of the recsys lookups, the GCN and the LM cells,
dense and MoE), run on 8 gloo ranks over a (2, 2, 2) mesh (and a (2, 2)
data x model mesh): each gathers to the plain function's output and
gradients."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

ROOT = os.path.join(os.path.dirname(__file__), "..")

# A world of 8 gloo processes on a (2, 2, 2) mesh, forked from one script;
# argv: store file, task. A failed check fails the process.
_GLOO_WORLD = textwrap.dedent("""
    import sys

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def work(rank, store, task):
        shape, axes = MESHES.get(task, ((2, 2, 2), ("pod", "data", "model")))
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank,
                                world_size=int(torch.tensor(shape).prod()))
        try:
            from repro_torch.launch.mesh import make_host_mesh

            torch.manual_seed(0)
            TASKS[task](make_host_mesh(shape, axes))
        finally:
            dist.destroy_process_group()


    def close(got, want, case, atol=1e-5):
        if hasattr(got, "full_tensor"):
            got = got.full_tensor()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol,
                                   msg=lambda m: f"{case}: {m}")


    # the LM programs sum fp32 partial products in another order (over the
    # data axes, model, then the layers): a few 1e-5 on logits of order 1
    LM_ATOL = 1e-4
    # the MoE programs: 2e-4 of the largest entry, twice the plain
    # function's own fp32 / fp64 difference on these random-init configs
    MOE_REL = 2e-4


    def lookups(mesh):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        from repro_torch.models import embedding as E

        R, S0 = Replicate(), Shard(0)
        g = torch.Generator().manual_seed(0)
        table = torch.randn((64, 4), generator=g)
        cases = [  # table placements, ids placements, ids shape
            ((S0, S0, S0), (S0, S0, R), (16,)),      # rows over all dims
            ((S0, S0, S0), (S0, S0, R), (8, 3)),
            ((R, R, S0), (S0, S0, R), (16,)),        # rows over model only
            ((S0, S0, S0), (R, R, R), (1, 5)),       # replicated ids
            ((R, R, R), (S0, S0, R), (16,)),         # a replicated table
        ]
        for limit in (E.ROWS_ALLREDUCE_LIMIT, 0):    # ids plan, table plan
            E.ROWS_ALLREDUCE_LIMIT = limit
            for pt, pi, shape in cases:
                ids = torch.randint(0, 64, shape, generator=g)
                w = torch.randn(shape + (4,), generator=g)
                t = table.clone().requires_grad_(True)
                want = t[ids]
                (want * w).sum().backward()
                dt = distribute_tensor(table, mesh, pt, src_data_rank=None)
                dt.requires_grad_(True)
                di = distribute_tensor(ids, mesh, pi, src_data_rank=None)
                dw = distribute_tensor(w, mesh, pi, src_data_rank=None)
                got = E.gather_rows(dt, di)
                close(got, want, (limit, pt, pi, shape))
                (got * dw).sum().backward()
                close(dt.grad.redistribute(mesh, [R] * 3), t.grad,
                      ("grad", limit, pt, pi, shape))
        bags = torch.randint(-1, 64, (8, 5), generator=g)
        w = torch.randn((8, 4), generator=g)
        for combiner in ("sum", "mean"):
            t = table.clone().requires_grad_(True)
            want = E.embed_bag(t, bags, combiner=combiner)
            (want * w).sum().backward()
            dt = distribute_tensor(table, mesh, (S0, S0, S0),
                                   src_data_rank=None).requires_grad_(True)
            got = E.embed_bag(dt, distribute_tensor(bags, mesh, (S0, S0, R),
                                                    src_data_rank=None),
                              combiner=combiner)
            close(got, want, combiner)
            (got * distribute_tensor(w, mesh, (S0, S0, R),
                                     src_data_rank=None)).sum().backward()
            close(dt.grad.redistribute(mesh, [R] * 3), t.grad,
                  ("bag grad", combiner))


    def gcn(mesh):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        from repro_torch.models import gnn as G

        R, S0, S1 = Replicate(), Shard(0), Shard(1)
        g = torch.Generator().manual_seed(1)
        cfg = G.GCNConfig(n_layers=2, d_in=6, d_hidden=5, n_classes=3)
        params = G.gcn_init(cfg, torch.Generator().manual_seed(2),
                            device="cpu")
        for n, e in ((32, 16), (16, 48)):             # edge plan, node plan
            edges = torch.randint(0, n + 1, (2, e), generator=g)  # n = pad
            feats = torch.randn((n, cfg.d_in), generator=g)
            labels = torch.randint(0, 3, (n,), generator=g)
            mask = (torch.rand(n, generator=g) > 0.3).float()
            loss = G.gcn_loss(params, feats, edges, labels, mask, cfg)
            want = torch.autograd.grad(loss, list(params.values()))
            for pn, pe in (((S0, S0, S0), (S1, S1, S1)),
                           ((R, R, R), (S1, R, R)),
                           ((S0, R, S0), (R, S1, R)),
                           ((S0, R, R), (S1, R, R))):   # data split
                dp = {k: distribute_tensor(v.detach(), mesh, [R] * 3,
                                           src_data_rank=None)
                      .requires_grad_(True) for k, v in params.items()}
                place = lambda x, p: distribute_tensor(  # noqa: E731
                    x, mesh, p, src_data_rank=None)
                got = G.gcn_loss(dp, place(feats, pn), place(edges, pe),
                                 place(labels, pn), place(mask, pn), cfg)
                close(got, loss, (n, pn, pe))
                grads = torch.autograd.grad(got, list(dp.values()))
                for a, b, k in zip(grads, want, params):
                    close(a.redistribute(mesh, [R] * 3), b,
                          ("grad", k, n, pn, pe))
        # the readout: per-graph mean pools of sharded node rows
        n, graphs = 32, 4
        feats = torch.randn((n, cfg.d_in), generator=g)
        edges = torch.randint(0, n, (2, 16), generator=g)
        gid = torch.arange(n) // (n // graphs)
        labels = torch.randint(0, 3, (graphs,), generator=g)
        loss = G.graph_readout_loss(params, feats, edges, gid, labels,
                                    graphs, cfg)
        want = torch.autograd.grad(loss, list(params.values()))
        dp = {k: distribute_tensor(v.detach(), mesh, [R] * 3,
                                   src_data_rank=None).requires_grad_(True)
              for k, v in params.items()}
        got = G.graph_readout_loss(
            dp, distribute_tensor(feats, mesh, (S0, S0, S0),
                                  src_data_rank=None),
            distribute_tensor(edges, mesh, (S1, S1, S1), src_data_rank=None),
            distribute_tensor(gid, mesh, (S0, S0, S0), src_data_rank=None),
            distribute_tensor(labels, mesh, [R] * 3, src_data_rank=None),
            graphs, cfg)
        close(got, loss, "readout")
        for a, b in zip(torch.autograd.grad(got, list(dp.values())), want):
            close(a.redistribute(mesh, [R] * 3), b, "readout grad")
        # the sampled minibatch: two edge lists on the edge plan, the seed
        # rows gathered, their gradient back on the rows' own ranks
        n, seeds = 32, 8
        feats = torch.randn((n, cfg.d_in), generator=g)
        lists = [torch.randint(0, n + 1, (2, e), generator=g)
                 for e in (16, 8)]
        labels = torch.randint(0, 3, (seeds,), generator=g)
        loss = G.sampled_loss(params, feats, lists, labels, seeds, cfg)
        want = torch.autograd.grad(loss, list(params.values()))
        dp = {k: distribute_tensor(v.detach(), mesh, [R] * 3,
                                   src_data_rank=None).requires_grad_(True)
              for k, v in params.items()}
        got = G.sampled_loss(
            dp, distribute_tensor(feats, mesh, (S0, S0, S0),
                                  src_data_rank=None),
            [distribute_tensor(e, mesh, (S1, S1, S1), src_data_rank=None)
             for e in lists],
            distribute_tensor(labels, mesh, (S0, S0, S0),
                              src_data_rank=None), seeds, cfg)
        close(got, loss, "sampled")
        for a, b in zip(torch.autograd.grad(got, list(dp.values())), want):
            close(a.redistribute(mesh, [R] * 3), b, "sampled grad")


    def decode(mesh, params, cfg, place, g):
        # decode against the plain step: rows over the data axes, then
        # one row (the cache over every axis); values and the cache
        import dataclasses

        from torch.distributed.tensor import Replicate, distribute_tensor

        from repro_torch.models import transformer as T
        from repro_torch.models import transformer_spmd as TS
        from repro_torch.runtime.sharding import lm_decode_shardings

        kv, b = cfg.n_kv_heads, 8
        dcfg = dataclasses.replace(cfg, max_seq_len=48)
        for rows in (b, 1):
            pspec, cspec, tspec = lm_decode_shardings(dcfg, mesh, batch=rows)
            shape = (cfg.n_layers, rows, 48, kv, cfg.d_head)
            cache = {"k": torch.randn(shape, generator=g),
                     "v": torch.randn(shape, generator=g),
                     "length": torch.tensor(20, dtype=torch.int32)}
            tok1 = torch.randint(0, cfg.vocab, (rows,), generator=g)
            dc = {"k": place(cache["k"], cspec["k"]),
                  "v": place(cache["v"], cspec["v"]),
                  "length": distribute_tensor(
                      cache["length"].clone(), mesh,
                      [Replicate()] * mesh.ndim, src_data_rank=None)}
            dp = {n: place(p, pspec[n]) for n, p in params.items()}
            want, cache = T.decode_step(params, cache, tok1, dcfg)
            got, dc = TS.decode_step(dp, dc, place(tok1, tspec), dcfg)
            case = (cfg.name, kv, cfg.n_heads, rows)
            close(got, want, ("decode",) + case, LM_ATOL)
            close(dc["k"], cache["k"], ("decode k",) + case, LM_ATOL)
            close(dc["v"], cache["v"], ("decode v",) + case, LM_ATOL)
            assert int(dc["length"].to_local()) == 21


    def lm(mesh):
        # the LM programs against the plain functions: MoE decode (query
        # heads split over model and whole), and dense prefill, decode and
        # the training loss and gradients, at the smoke configs with their
        # KV heads split over model and whole
        import dataclasses

        from torch.distributed.tensor import Replicate, distribute_tensor

        from repro_torch.configs import get_arch
        from repro_torch.models import transformer as T
        from repro_torch.models import transformer_spmd as TS
        from repro_torch.runtime.sharding import (
            data_axes, lm_decode_shardings, lm_param_rules, spec_for,
            to_placements)

        g = torch.Generator().manual_seed(4)
        base = get_arch("qwen3-8b").make_smoke_config()
        names = mesh.mesh_dim_names
        kinds = [1] if "pod" not in names else [base.n_kv_heads, 1]
        da = data_axes(mesh)

        def place(x, spec):
            return distribute_tensor(x.detach().clone(), mesh,
                                     to_placements(mesh, spec),
                                     src_data_rank=None)

        for arch, heads in (("qwen2-moe-a2.7b", 4),
                            ("llama4-maverick-400b-a17b", 8),
                            ("llama4-maverick-400b-a17b", 3)):
            # MoE decode; 3 query heads: model does not split them
            cfg = get_arch(arch).make_smoke_config()
            cfg = dataclasses.replace(cfg, n_heads=heads,
                                      n_kv_heads=min(cfg.n_kv_heads, heads)
                                      if heads % 2 == 0 else 1)
            model = T.Transformer(cfg, generator=torch.Generator()
                                  .manual_seed(heads), device="cpu")
            decode(mesh, {n: p.detach() for n, p in
                          model.named_parameters()}, cfg, place, g)
        for kv in kinds:
            cfg = dataclasses.replace(base, n_kv_heads=kv)
            model = T.Transformer(cfg, generator=torch.Generator()
                                  .manual_seed(kv), device="cpu")
            params = {n: p.detach() for n, p in model.named_parameters()}
            b, s = 8, 32
            # prefill
            pcfg = dataclasses.replace(cfg, max_seq_len=s)
            specs = lm_param_rules(pcfg, mesh)
            dp = {n: place(p, specs[n]) for n, p in params.items()}
            tok = torch.randint(0, cfg.vocab, (b, s), generator=g)
            want, cache = T.prefill(params, tok, pcfg)
            _, cspec, _ = lm_decode_shardings(pcfg, mesh, batch=b)
            got, gcache = TS.prefill(
                dp, place(tok, spec_for(mesh, (b, s), (da, None))), pcfg,
                cspec["k"])
            close(got, want, ("prefill", kv))
            close(gcache["k"], cache["k"], ("prefill k", kv))
            close(gcache["v"], cache["v"], ("prefill v", kv))
            decode(mesh, params, cfg, place, g)
            # training: the loss and every parameter's gradient
            specs = lm_param_rules(cfg, mesh)
            leaves = {n: p.clone().requires_grad_(True)
                      for n, p in params.items()}
            lab = torch.randint(-1, cfg.vocab, (b, s), generator=g)
            loss, _ = T.loss_fn(leaves, tok, lab, cfg)
            want = torch.autograd.grad(loss, list(leaves.values()))
            dp = {n: place(p, specs[n]).requires_grad_(True)
                  for n, p in params.items()}
            bspec = spec_for(mesh, (b, s), (da, None))
            got = TS.train_loss(dp, place(tok, bspec), place(lab, bspec), cfg)
            close(got, loss, ("loss", kv))
            for n, a, w in zip(dp, torch.autograd.grad(got, list(dp.values())),
                               want):
                close(a.redistribute(mesh, [Replicate()] * mesh.ndim), w,
                      ("grad", n, kv))
        moe(mesh, place, g)


    def _moe_atol(want):
        return MOE_REL * max(1.0, want.abs().max().item())


    def moe(mesh, place, g):
        # the MoE train and prefill programs against the plain loss (with
        # its aux loss) and gradients, and prefill's logits and cache: both
        # smoke configs, llama4's with query heads model does not split,
        # qwen2's with slots dropped, and microbatches of replicated rows
        import dataclasses

        from torch.distributed.tensor import Replicate

        from repro_torch.configs import get_arch
        from repro_torch.models import transformer as T
        from repro_torch.models import transformer_spmd as TS
        from repro_torch.runtime.sharding import (
            data_axes, lm_decode_shardings, lm_param_rules, spec_for)

        da = data_axes(mesh)
        b, s = 8, 32
        qwen = get_arch("qwen2-moe-a2.7b").make_smoke_config()
        llama = get_arch("llama4-maverick-400b-a17b").make_smoke_config()
        cases = [  # config, microbatches
            (qwen, 1), (llama, 1),
            (dataclasses.replace(llama, n_heads=3, n_kv_heads=1,
                                 n_layers=2), 1),
            # capacity 8 slots an expert for 512 slots a microbatch
            (dataclasses.replace(qwen, moe=dataclasses.replace(
                qwen.moe, capacity_factor=0.1)), 2)]
        for n, (cfg, n_micro) in enumerate(cases):
            model = T.Transformer(cfg, generator=torch.Generator()
                                  .manual_seed(10 + n), device="cpu")
            params = {k: p.detach() for k, p in model.named_parameters()}
            tok = torch.randint(0, cfg.vocab, (b, s), generator=g)
            lab = torch.randint(-1, cfg.vocab, (b, s), generator=g)
            case = (cfg.name, cfg.n_heads, cfg.moe.capacity_factor, n_micro)
            specs = lm_param_rules(cfg, mesh)
            bspec = spec_for(mesh, (b, s), (da, None))
            for i in range(n_micro):
                rows = slice(i * b // n_micro, (i + 1) * b // n_micro)
                leaves = {k: p.clone().requires_grad_(True)
                          for k, p in params.items()}
                loss, _ = T.loss_fn(leaves, tok[rows], lab[rows], cfg)
                want = torch.autograd.grad(loss, list(leaves.values()))
                dp = {k: place(p, specs[k]).requires_grad_(True)
                      for k, p in params.items()}
                got = TS.train_loss(dp, place(tok, bspec), place(lab, bspec),
                                    cfg, i, n_micro)
                close(got, loss, ("moe loss", i) + case, _moe_atol(loss))
                for k, a, w in zip(dp, torch.autograd.grad(
                        got, list(dp.values())), want):
                    close(a.redistribute(mesh, [Replicate()] * mesh.ndim), w,
                          ("moe grad", k, i) + case, _moe_atol(w))
            pcfg = dataclasses.replace(cfg, max_seq_len=s)
            specs = lm_param_rules(pcfg, mesh)
            dp = {k: place(p, specs[k]) for k, p in params.items()}
            want, cache = T.prefill(params, tok, pcfg)
            _, cspec, _ = lm_decode_shardings(pcfg, mesh, batch=b)
            got, gcache = TS.prefill(dp, place(tok, bspec), pcfg, cspec["k"])
            close(got, want, ("moe prefill",) + case, _moe_atol(want))
            for kv in ("k", "v"):
                close(gcache[kv], cache[kv], ("moe prefill", kv) + case,
                      _moe_atol(cache[kv]))


    TASKS = {"lookups": lookups, "gcn": gcn, "lm": lm, "lm_exchange": lm}
    # the decode's exchange of wk / wv rows needs data as large as model;
    # on it the MoE train step gathers the microbatch's slot rows
    MESHES = {"lm_exchange": ((2, 2), ("data", "model"))}

    if __name__ == "__main__":
        shape = MESHES.get(sys.argv[2], ((2, 2, 2),))[0]
        mp.start_processes(work, args=tuple(sys.argv[1:3]),
                           nprocs=int(torch.tensor(shape).prod()),
                           start_method="fork")
""")


def _gloo_world(tmp_path, task: str) -> None:
    script = tmp_path / "world.py"
    script.write_text(_GLOO_WORLD)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store"), task],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]


@pytest.mark.parametrize("task", ["lookups", "gcn", "lm", "lm_exchange"])
def test_sharded_programs_gather_to_the_plain_results(tmp_path, task):
    """``lookups``: ``gather_rows`` on row-sharded tables (rows over every
    mesh dim or one, a replicated table; batch-sharded or replicated ids),
    under the ids plan and the table plan, and ``embed_bag`` (sum, mean):
    values and the table's gradient. ``gcn``: ``gcn_loss`` on node rows and
    edges sharded for the edge plan and the node plan, and the readout's
    per-graph sums (the node plan also on ``data`` split by the rows'
    factor), and ``sampled_loss`` on two edge lists (its seed rows
    gathered): the loss and every parameter's gradient. ``lm`` (and
    ``lm_exchange`` on a (2, 2) data x model mesh, where the decode moves
    ``wk`` / ``wv`` rows by an exchange and the MoE train step gathers
    the microbatch's slot rows): the LM cells' rank-local programs
    against prefill, decode and the loss and its gradients, dense, and
    MoE on both smoke configs (with slots dropped, two microbatches,
    query heads ``model`` does not split)."""
    _gloo_world(tmp_path, task)

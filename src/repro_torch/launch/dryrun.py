"""Multi-pod dry-run: run EVERY (arch x shape x mesh) cell once on a fake
cluster and write its roofline terms (port of :mod:`repro.launch.dryrun`).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k --mesh multi --out results/dryrun_torch

For each (cell, mesh) it brings up the ``"fake"`` process group at the
mesh's world size (256 or 512; destroyed and brought up again between
meshes, the counterpart of the reference's 512 forced host devices), builds
the cell, places every argument as a DTensor over a fake local shard of its
per-chip shape (no storage), runs the step once as rank 0 under
:class:`~repro_torch.roofline.StepCounter` (its results named as the
step's outputs, so work that reaches none of them is dead code, as in
XLA), and writes one JSON per (cell, mesh) with the reference's keys under
``--out`` for
``python -m repro_torch.benchmarks.roofline_report``. Nothing is computed
and no card is touched: the mesh is a ``"cpu"`` ``DeviceMesh``, so the
kernels' plain versions trace (the ctypes-bound CUDA kernels cannot run on
fake tensors).

How the port's run differs from the reference's compile, and where it
follows it (``scripts/dryrun_parity.py`` holds every (cell, mesh)'s
collective bytes, flops and bytes accessed to the reference's, within
20 %):

* The flops and bytes of a counted cell (``counted_*_per_chip``, also by
  instruction class in ``counted_*_by_class``) are the counter's model of
  XLA:CPU's ``cost_analysis()`` on the step's local ops
  (:mod:`repro_torch.roofline.cost_model`), which the reference reports.
  On the fake shards a 16-bit product takes the card's fp32-output
  overload (``models.transformer.matmul32``), not the CPU's upcast.
* The LM cells loop over identical blocks (and train cells over
  microbatches). A cell with ``at_depth`` runs at 1 and 2 blocks (x 1 and 2
  microbatches of the cell's size) and every count is extrapolated to the
  full depth and microbatch count (the reference's HLO parse multiplies a
  scan body's collectives by its trip count); their flops and bytes come
  from the cell's closed-form ``analytic``, as in the reference.
* The steps whose collectives DTensor's op-by-op placement would pick
  otherwise than the reference's compile run rank-local programs on the
  local shards, with the collectives the reference's HLO shows (each
  module's docstring states its schedule): every LM cell
  (:mod:`repro_torch.models.transformer_spmd`), the recsys cells'
  row-sharded lookups (``models.embedding.gather_rows``) and the
  GCN's aggregation (``models.gnn``); a gradient partial over several
  mesh dims is all-reduced over their flattened group in one
  collective, as XLA reduces it (``configs.common._place_grad``).
* Where DTensor cannot place an op (no sharding rule, or a layout its
  propagation refuses), the counter runs it on replicated inputs: every
  DTensor argument is gathered first and the implied all-gathers are
  charged (``StepCounter._dtensor_op``). Each JSON lists those ops
  (``replicated_ops``); none of the 44 cells has one, and none carries a
  ``collective_caveat`` (``collective_comparable`` is true throughout).
* DTensor on a ``"cpu"`` mesh replaces an all-to-all by an all-gather and a
  chunk (the gloo backend has no all-to-all); the dry-run routes it to the
  all-to-all op instead, which the counter charges as one. And it takes
  DTensor's greedy redistribution plan where DTensor would search for the
  least-cost one (the search explodes on a 3-D mesh). Both patches hold
  for the rest of the process.

The LM cells take from under a second (decode) to about 30 s (train_4k)
and 70-80 s (prefill_32k, the blockwise attention's loops in fake
tensors) each; llama4's prefill about two minutes a mesh. One process per
``--arch`` runs them side by side (about 1 GB each).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, all_cells
from ..configs.common import tree_leaves, tree_map
from ..roofline import HW_H100, StepCounter, roofline_terms
from ..runtime.sharding import P, local_shape, mesh_axes, to_placements
from .mesh import PRODUCTION_SHAPES, fake_world, make_production_mesh

__all__ = ["MESHES", "run_cell", "run_step", "main"]

print = functools.partial(print, flush=True)

MESHES = {"single": False, "multi": True}


def _greedy_redistribution_plans():
    """DTensor plans a redistribution through a _StridedShard layout by a
    least-cost graph search, which explodes on a 3-D mesh; the dry-run
    takes DTensor's greedy plan (one collective per mesh dim that
    changes), falling back to the search only where greedy refuses."""
    from torch.distributed.tensor import _redistribute as R

    planner = next((v for v in vars(R).values() if isinstance(v, type) and
                    hasattr(v, "generate_graph_based_transform_infos")), None)
    if planner is None or getattr(planner, "_dryrun_greedy", False):
        return                      # a torch without the search, or done
    search = planner.generate_graph_based_transform_infos

    def plan(self, src_spec, dst_spec, *args, **kwargs):
        try:
            return self.generate_greedy_transform_infos(src_spec, dst_spec)
        except Exception:  # noqa: BLE001 — greedy refuses this layout
            return search(self, src_spec, dst_spec, *args, **kwargs)

    planner.generate_graph_based_transform_infos = plan
    planner._dryrun_greedy = True


def _alltoall_on_cpu_mesh():
    """DTensor's shard_dim_alltoall without its cpu-mesh all-gather
    fallback: the all-to-all op itself (its fake kernel gives the shape)."""
    try:
        from torch.distributed._functional_collectives import (
            _group_or_group_name, _resolve_group)
        from torch.distributed.tensor import placement_types
    except ImportError:                 # a torch without these: keep its own
        return
    if not hasattr(placement_types, "shard_dim_alltoall"):
        return

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = _resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, _group_or_group_name(group))

    placement_types.shard_dim_alltoall = shard_dim_alltoall


def _dtensors(args, specs, mesh, fake_mode):
    """Every tensor argument as a DTensor placed by its spec over a fake
    local shard; other leaves pass."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    def place(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        spec = spec if isinstance(spec, P) else P()
        with fake_mode:
            loc = torch.empty(local_shape(mesh, x.shape, spec), dtype=x.dtype)
        # a spec out of mesh order (the recsys tables) in mesh order: the
        # same per-chip shapes and collective bytes, and no data to hold
        # the reference's rows; DTensor's strided redistributions do not
        # run on fake shards
        pls = tuple(Shard(p.dim) if isinstance(p, _StridedShard) else p
                    for p in to_placements(mesh, spec))
        return DTensor.from_local(loc, mesh, pls,
                                  run_check=False, shape=x.shape,
                                  stride=torch.empty(x.shape,
                                                     device="meta").stride())

    return tree_map(place, args, specs)


def arg_bytes(mesh, args, specs) -> int:
    """Exact per-chip bytes of the arguments under their specs."""
    total = 0
    flat_specs = dict(tree_leaves(specs))
    for path, x in tree_leaves(args):
        if isinstance(x, torch.Tensor):
            spec = flat_specs.get(path, P())
            shape = local_shape(mesh, x.shape, spec)
            total += int(torch.Size(shape).numel()) * x.element_size()
    return total


def run_step(cell, mesh, hw=HW_H100) -> tuple[dict, int, float]:
    """Run ``cell``'s step once on ``mesh`` as rank 0 -> (counter report,
    per-chip argument bytes, build seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    _alltoall_on_cpu_mesh()
    _greedy_redistribution_plans()
    t0 = time.perf_counter()
    fn, args, in_specs, _ = cell.build(mesh)
    build_s = time.perf_counter() - t0
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    dargs = _dtensors(args, in_specs, mesh, fake)
    counter = StepCounter(hw, fake_mode=fake)
    with fake, counter, implicit_replication():
        out = fn(*dargs)
        counter.outputs(tree_map(
            lambda x: getattr(x, "_local_tensor", x), out))
    return counter.report(), arg_bytes(mesh, args, in_specs), build_s


def _extrapolate(runs: dict, blocks: int, micro: int) -> dict:
    """Counts at (1 | 2 blocks) x (1 | 2 microbatches) -> counts at
    (``blocks``, ``micro``): exact for counts that grow linearly in each and
    bilinearly in both (a block's collectives once per microbatch). The
    peak grows with depth only (one microbatch's graph lives at a time)."""
    r11, r21 = runs[1, 1], runs[2, 1]
    r12, r22 = runs.get((1, 2), r11), runs.get((2, 2), r21)

    def grid(a, b, c, d):
        return (a + (blocks - 1) * (b - a) + (micro - 1) * (c - a)
                + (blocks - 1) * (micro - 1) * (d - b - c + a))

    out = {"replicated_ops": sorted(set().union(
        *(r["replicated_ops"] for r in runs.values())))}
    for key, a in r11.items():
        if key == "replicated_ops":
            continue
        if key == "peak_step_bytes":
            out[key] = a + (blocks - 1) * max(r21[key] - a, 0)
        elif isinstance(a, dict):
            out[key] = {k: grid(a[k], r21[key][k], r12[key][k], r22[key][k])
                        for k in a}
        else:
            out[key] = grid(a, r21[key], r12[key], r22[key])
    return out


def run_cell(cell, mesh_name: str, out_dir: str | None, hw=HW_H100) -> dict:
    multi = MESHES[mesh_name]
    shape, _ = PRODUCTION_SHAPES[multi]
    n_devices = int(torch.Size(shape).numel())
    t0 = time.perf_counter()
    with fake_world(n_devices):
        mesh = make_production_mesh(multi_pod=multi)
        if cell.at_depth is not None:
            runs, build_s = {}, 0.0
            for m in ((1, 2) if cell.micro > 1 else (1,)):
                for d in (1, 2):
                    runs[d, m], _, b = run_step(cell.at_depth(d, m), mesh, hw)
                    build_s += b
            counts = _extrapolate(runs, cell.blocks, cell.micro)
            fn, args, in_specs, _ = cell.build(mesh)
            ab = arg_bytes(mesh, args, in_specs)
            source = (f"analytic; counts at 1-2 blocks x 1-2 microbatches, "
                      f"extrapolated to {cell.blocks} x {cell.micro}")
        else:
            counts, ab, build_s = run_step(cell, mesh, hw)
            source = "counted"
        mesh_shape = mesh_axes(mesh)
    run_s = time.perf_counter() - t0 - build_s
    flops, nbytes = counts["flops"], counts["bytes"]
    report = {
        "n_devices": n_devices,
        "counted_flops_per_chip": flops,
        "counted_bytes_per_chip": nbytes,
        "counted_flops_by_class": counts["flops_by_class"],
        "counted_bytes_by_class": counts["bytes_by_class"],
    }
    if cell.analytic is not None:
        a = cell.analytic(make_production_mesh(multi_pod=multi, abstract=True))
        flops, nbytes = a["flops"], a["bytes"]
    report.update({
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": nbytes,
        "flops_source": source,
        "collective_bytes_per_chip": counts["collective_bytes"],
        "cross_node_bytes_per_chip": counts["cross_node_bytes"],
        "collective_detail": counts["collective_detail"],
        "collective_counts": counts["collective_counts"],
        "memory_analysis": {
            "argument_size_in_bytes": ab,
            "temp_size_in_bytes": int(counts["peak_step_bytes"]),
        },
        "replicated_ops": counts["replicated_ops"],
        "collective_comparable": not cell.caveat(mesh_name),
        "collective_caveat": cell.caveat(mesh_name),
        "hardware": hw.name,
        **roofline_terms(flops=flops, bytes_accessed=nbytes,
                         collective_bytes=counts["collective_bytes"],
                         cross_node_bytes=counts["cross_node_bytes"],
                         n_devices=n_devices, hw=hw),
    })
    if cell.model_flops:
        report["model_flops"] = cell.model_flops
        total = flops * n_devices
        report["useful_flops_ratio"] = (cell.model_flops / total
                                        if total > 0 else 0.0)
    report.update(
        arch=cell.arch, shape=cell.shape, kind=cell.kind, mesh=mesh_name,
        mesh_shape=mesh_shape, lower_s=round(build_s, 2),
        compile_s=round(run_s, 2), note=cell.note,
    )
    print(
        f"  roofline: compute={report['t_compute_s']:.3e}s "
        f"memory={report['t_memory_s']:.3e}s "
        f"collective={report['t_collective_s']:.3e}s "
        f"-> {report['bottleneck']}-bound "
        f"(frac={report['roofline_fraction']:.3f}); args "
        f"{ab / 2**30:.3f} GiB/chip, step peak "
        f"{report['memory_analysis']['temp_size_in_bytes'] / 2**30:.3f} GiB"
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{cell.arch}__{cell.shape}__{mesh_name}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable); default: all")
    ap.add_argument("--shape", default=None, help="only this shape cell")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = args.arch or list(ARCH_IDS)
    cells = [c for c in all_cells(archs)
             if args.shape is None or c.shape == args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures, n_ok = [], 0
    for cell in cells:
        for mesh_name in meshes:
            print(f"[dryrun] {cell.name} on {mesh_name} "
                  f"({'2x16x16' if mesh_name == 'multi' else '16x16'})")
            try:
                run_cell(cell, mesh_name, args.out)
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((cell.name, mesh_name, repr(e)))
                traceback.print_exc()
    print(f"\n[dryrun] {n_ok} ok, {len(failures)} failed")
    for name, mesh_name, err in failures:
        print(f"  FAIL {name} [{mesh_name}]: {err[:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Attributes the reference's ``bytes accessed`` (XLA:CPU's
``cost_analysis()`` of a compiled dry-run cell) to the top-level
instructions of its optimized module, the way the port's cost model
(``repro_torch.roofline.cost_model``) reads it::

    PYTHONPATH=src python scripts/xla_cost_attribution.py gcn-cora molecule
    PYTHONPATH=src python scripts/xla_cost_attribution.py bst retrieval_cand \\
        --mesh multi --top 20

It compiles ``repro.launch.dryrun``'s program for the cell (JAX on 512
forced host devices, set before JAX starts), sums each top-level
instruction's operands and result (a fusion as one instruction; a fusion
operand read only through slices counts their results; the ``TopK``
custom call counts nothing; parameters, tuples, bitcasts and constants
count nothing), prints that sum beside ``bytes accessed`` and the
largest instructions grouped by opcode (a fusion by the set of opcodes it
fuses). A reference-side tool: it imports JAX and the reference.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

_WIDTH = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2, "s8": 1,
          "u8": 1, "pred": 1, "s64": 8, "u64": 8, "f64": 8, "s16": 2,
          "u16": 2}
_SHAPE = re.compile(r"(" + "|".join(_WIDTH) + r")\[([0-9,]*)\]")
_FREE = {"parameter", "get-tuple-element", "tuple", "bitcast", "constant",
         "after-all", "partition-id", "replica-id"}


def shape_bytes(text: str) -> int:
    """Bytes of every array shape in an HLO type (a tuple sums)."""
    total = 0
    for dt, dims in _SHAPE.findall(text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _WIDTH[dt]
    return total


def parse(text: str) -> dict:
    """{computation name ("ENTRY" for the entry): [instruction dicts]}."""
    comps, cur = {}, None
    for line in text.splitlines():
        head = re.match(r"^(ENTRY )?%(\S+) .*\{$", line)
        if head:
            cur = comps.setdefault("ENTRY" if head.group(1) else
                                   head.group(2), [])
            continue
        if line.startswith("}"):
            cur = None
            continue
        m = cur is not None and re.match(
            r"\s*(?:ROOT )?%(\S+) = (.*?) ([a-z\-]+)\((.*)$", line)
        if not m:
            continue
        name, typ, op, rest = m.groups()
        depth, i = 1, 0
        while i < len(rest) and depth:
            depth += (rest[i] == "(") - (rest[i] == ")")
            i += 1
        cur.append({"name": name, "type": typ, "op": op, "line": line,
                    "operands": re.findall(r"%([\w\.\-]+)", rest[:i - 1])})
    return comps


def _operand_reads(ins, comps, sym) -> int:
    """Bytes an instruction reads of its operands: a fusion parameter used
    only through slices reads their results."""
    called = re.search(r"calls=%([\w\.\-]+)", ins["line"])
    body = comps.get(called.group(1), []) if ins["op"] == "fusion" \
        and called else []
    params = {int(re.search(r"parameter\((\d+)\)", b["line"]).group(1)):
              b["name"] for b in body if b["op"] == "parameter"}
    total = 0
    for i, o in enumerate(ins["operands"]):
        full = shape_bytes(sym[o]["type"]) if o in sym else 0
        users = [b for b in body if params.get(i) in b["operands"]]
        if users and all(u["op"] in ("slice", "dynamic-slice")
                         and u["operands"][0] == params[i] for u in users):
            total += min(full, sum(shape_bytes(u["type"]) for u in users))
        else:
            total += full
    return total


def attribute(text: str) -> list[tuple[str, str, int]]:
    """(instruction, group, bytes) of each top-level instruction."""
    comps = parse(text)
    sym = {i["name"]: i for i in comps["ENTRY"]}
    rows = []
    for ins in comps["ENTRY"]:
        if ins["op"] in _FREE:
            continue
        group = ins["op"]
        if group == "custom-call":
            target = re.search(r'custom_call_target="([^"]+)"', ins["line"])
            group = f"custom-call[{target.group(1)}]"
            if target.group(1) == "TopK":
                rows.append((ins["name"], group, 0))
                continue
        if group == "fusion":
            called = re.search(r"calls=%([\w\.\-]+)", ins["line"]).group(1)
            group = "fusion[" + ",".join(sorted(
                {b["op"] for b in comps.get(called, [])} - _FREE)) + "]"
        rows.append((ins["name"], group, _operand_reads(ins, comps, sym)
                     + shape_bytes(ins["type"])))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.configs import get_arch
    from repro.launch.mesh import make_production_mesh

    cell = next(c for c in get_arch(args.arch).cells()
                if c.shape == args.shape)
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    fn, cargs, ins, outs = cell.build(mesh)
    named = lambda t: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(mesh, s), t,
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    with jax.set_mesh(mesh):
        compiled = jax.jit(fn, in_shardings=named(ins),
                           out_shardings=named(outs)).lower(*cargs).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    rows = attribute(compiled.as_text())
    total = sum(b for _, _, b in rows)
    print(f"{cell.name} [{args.mesh}]: instructions' operands + results "
          f"{total:.6g} B, bytes accessed {cost['bytes accessed']:.6g} B "
          f"(ratio {total / cost['bytes accessed']:.4f}); flops "
          f"{cost.get('flops', 0.0):.6g}")
    by_group = collections.Counter()
    for _, group, b in rows:
        by_group[group] += b
    for group, b in by_group.most_common(args.top):
        print(f"  {b / 1e6:14.4f} MB  {group}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""A model of XLA:CPU's ``cost_analysis()``: the flops and ``bytes
accessed`` the reference's compiled step reports, charged on the ops
:class:`~repro_torch.roofline.StepCounter` records as the port's step runs.

The reference has no fusion model of its own; its numbers are what
``HloCostAnalysis`` charges the optimized, fused HLO module. The port has
no compiler to ask, so it records each local op as a :class:`Node` (its
class, its flops, and the buffers it reads and writes as value ids and
bytes) and :func:`charge` groups the nodes the way XLA:CPU fuses them and
charges each group as ``HloCostAnalysis`` charges an instruction:

* **fuse** (pointwise ops, converts, copies, ``where``, ``cat``, pads,
  fills, iotas; views cost nothing): a producer is inlined into its
  consumers when every consumer is a fusible op (duplicated into each when
  there are several) and materialized otherwise; an expensive producer (a
  transcendental, a divide, a reduce, a gather) is inlined only into one
  consumer that reads each of its elements once. A group (one materialized value and the
  producers inlined into it) reads each distinct outside buffer once (a
  read through a slice only its part) and writes its value. Flops: one an
  element per arithmetic, compare, select or convert op; transcendentals
  count none.
* **dot** (``mm``, ``bmm``, the flop registry's products; ``addmm`` /
  ``baddbmm`` as a dot plus a fusible bias add): operands (transposes and
  reshapes feeding them are views) plus the result; 2·M·N·K flops.
  Producers are not fused into it.
* **reduce**: a reduce whose reduced dims are at most 32 long is fusible
  (an expensive one). A longer reduced dim is split as XLA:CPU's tree
  reduction does (a reduce-window of 32, then a reduce): its own
  instruction, its input materialized, the partial sums written and read
  once more. Flops: input elements less output elements, times 9 for a
  variadic (``argmax``-style) reduce.
* **gather** (``index_select``, ``embedding``, advanced ``index``,
  ``gather``): fusible, but its table operand is read whole.
* **scatter** (``index_add``, ``scatter_add``, ``index_put``): operand,
  indices, updates and result; a flop an update element when it adds.
* **sort**: operand plus result, N·ceil(log2 N) flops over all N
  elements. A descending f32 sort of rank at most 2 whose results are only
  read as a prefix along the sorted dim is XLA's TopK (its
  ``TopkRewriter``), and **topk** charges nothing.
* **collective**: operand plus result bytes; an all-reduce or
  reduce-scatter adds a flop a result element. (The ring term is the
  counter's own, apart from this.)

A node none of whose results reaches the step's outputs is dead and is
dropped, as XLA's dead-code elimination drops it (only where the caller
named the outputs). ``tests/test_torch_roofline.py`` holds the model to
XLA:CPU's ``cost_analysis()`` on twin programs, within 1 %.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Node", "charge", "reduce_mid", "CLASSES", "TREE_WINDOW",
           "VARIADIC_REDUCE_FLOPS"]

CLASSES = ("fuse", "gather", "dot", "reduce", "scatter", "sort", "topk",
           "collective", "other")
TREE_WINDOW = 32              # XLA:CPU's tree-reduction window
VARIADIC_REDUCE_FLOPS = 9     # the (value, index) reducer's instructions


@dataclasses.dataclass
class Node:
    """One recorded op. ``ins``: (value id, bytes read, the value's whole
    bytes, the view read: two reads of one view are one read); ``outs``:
    (value id, bytes written). ``mid``: a reduce's partial-sum bytes (0
    when it is not split). ``size``: the elements of its (first) result.
    ``partial``: a fusible op that writes into part of a buffer (its
    result stays in memory; the buffer it updates is read as 0 bytes). ``sort_f32_desc``: a sort XLA's TopkRewriter
    may take (:func:`charge` turns it into a ``topk`` node)."""
    cls: str
    name: str
    flops: float
    ins: list
    outs: list
    expensive: bool = False
    mid: float = 0.0
    size: int = 0
    partial: bool = False
    sort_f32_desc: bool = False


# consumers a fusible producer can be inlined into
_FUSING = ("fuse", "gather")
# fusible ops with more result elements than they read of an operand,
# each element read once
_ONCE = {"cat", "stack", "constant_pad_nd", "select_backward",
         "slice_backward"}


def _dead(nodes, roots):
    """Indices of the nodes none of whose results reaches a root."""
    prod = {}
    for i, n in enumerate(nodes):
        for v, _ in n.outs:
            prod[v] = i
    live, stack = set(), [prod[v] for v in roots if v in prod]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        stack.extend(prod[v] for v, *_ in nodes[i].ins if v in prod)
    return set(range(len(nodes))) - live


def _topk_sorts(nodes, reads_of, roots):
    """XLA's TopkRewriter: a descending f32 sort every read of whose
    results is a prefix along the sorted dim becomes a TopK custom call."""
    for i, n in enumerate(nodes):
        if n.cls != "sort" or not n.sort_f32_desc:
            continue
        reads = [r for v, _ in n.outs for r in reads_of.get(v, ())]
        reads += [roots[v] for v, _ in n.outs if v in roots]
        if reads and all(r < w for r, w in reads):
            n.cls = "topk"


def _reuses(node, v) -> bool:
    """Whether ``node`` reads value ``v`` broadcast: a view with a
    repeated (stride 0) dim, or fewer elements than its result (a
    concatenate, pad or gather reads each element once)."""
    if node.name in _ONCE or node.cls == "gather":
        return False
    for u, _, _, key in node.ins:
        if u != v or key is None:
            continue
        _, shape, stride = key
        if any(st == 0 and sz > 1 for sz, st in zip(shape, stride)) or \
                math.prod(shape) < node.size:
            return True
    return False


def charge(nodes: list[Node], roots: dict | None = None) -> dict:
    """The recorded step's flops and bytes as XLA:CPU's cost analysis
    charges its fused module: ``{"flops", "bytes", "flops_by_class",
    "bytes_by_class"}`` (by the class of each charged instruction, a
    fusion by its root's). ``roots``: {value id: (bytes read, whole
    bytes)} of the step's results (None: every value no node reads)."""
    consumers: dict[int, list[int]] = {}
    reads_of: dict[int, list] = {}
    prod: dict[int, int] = {}
    for i, n in enumerate(nodes):
        for v, _ in n.outs:
            prod[v] = i
        for v, r, w, _ in n.ins:
            consumers.setdefault(v, []).append(i)
            reads_of.setdefault(v, []).append((r, w))
    if roots is None:
        roots = {v: (0, 1) for i, n in enumerate(nodes)
                 for v, _ in n.outs if v not in consumers}
        dead = set()
    else:
        dead = _dead(nodes, roots)
    _topk_sorts(nodes, reads_of, roots)

    def materialized(v) -> bool:
        if v not in prod:
            return True                       # a step input
        p = nodes[prod[v]]
        if p.cls not in _FUSING or p.partial or v in roots:
            return True
        if any(r == 0 < w for r, w in reads_of.get(v, ())):
            return True                       # updated in place
        users = [nodes[c] for c in consumers.get(v, ()) if c not in dead]
        if any(u.cls not in _FUSING for u in users):
            return True
        if not p.expensive:
            return False
        # an expensive producer is neither duplicated nor fused into a
        # consumer that reads each of its elements more than once
        return len(users) > 1 or any(_reuses(u, v) for u in users)

    mat = {v: materialized(v) for v in prod}
    flops = {c: 0.0 for c in CLASSES}
    nbytes = {c: 0.0 for c in CLASSES}
    for i, n in enumerate(nodes):
        if i in dead or n.cls == "topk":
            continue
        if n.cls not in _FUSING:
            flops[n.cls] += n.flops
            nbytes[n.cls] += sum(r for _, r, *_ in n.ins) + 2 * n.mid + sum(
                b for v, b in n.outs if v in roots or any(
                    c not in dead for c in consumers.get(v, ())))
            if n.cls == "scatter" and n.ins and n.ins[0][0] not in prod:
                nbytes[n.cls] += 2 * n.ins[0][2]   # a step input: copied
            continue
        for v, b in n.outs:
            if not mat[v]:
                continue
            f, reads, alone = _group(nodes, i, prod, mat)
            if alone and n.name in ("cat", "stack"):
                # a lone concatenate is no fusion: each operand is read
                reads = {k: (r, r) for k, (_, r, *_) in enumerate(n.ins)}
            flops[n.cls] += f
            nbytes[n.cls] += b + sum(min(r, w) for r, w in reads.values())
    return {"flops": sum(flops.values()), "bytes": sum(nbytes.values()),
            "flops_by_class": flops, "bytes_by_class": nbytes}


def _group(nodes, root, prod, mat):
    """A fusion rooted at node ``root``: its flops, per outside value it
    reads (bytes read, whole bytes) (a value read whole once is read whole;
    reads through distinct slices add up), and whether it is one node."""
    flops, views, seen, stack = 0.0, {}, set(), [root]
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        n = nodes[i]
        flops += n.flops
        for v, r, w, key in n.ins:
            if v in prod and not mat[v]:
                stack.append(prod[v])
            else:
                views.setdefault(v, {})[key] = (r, w)
    reads = {}
    for v, by_view in views.items():
        w = next(iter(by_view.values()))[1]
        reads[v] = (min(w, sum(r for r, _ in by_view.values())), w)
    return flops, reads, len(seen) == 1


def reduce_mid(shape, dims, out_itemsize) -> float:
    """Bytes of the partial sums XLA:CPU's tree reduction writes for a
    reduce of ``shape`` over ``dims`` (0 when no reduced dim exceeds the
    window)."""
    if not any(shape[d] > TREE_WINDOW for d in dims):
        return 0.0
    n = 1
    for d, s in enumerate(shape):
        n *= math.ceil(s / min(s, TREE_WINDOW)) if d in dims else s
    return float(n * out_itemsize)

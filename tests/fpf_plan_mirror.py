"""Python mirror of a ``fpf_iter`` CTA's prologue, for the plan tests on the
CPU and the card: which of its rows a CTA holds in shared memory, and in
which form. Imports neither JAX nor the reference package."""

from repro_torch.kernels.fpf_iter import ops as fops

# kMinHeldBytes in the CUDA source: a held compacted row's table entry,
# lane counts and one entry
MIN_HELD_BYTES = 4 + fops._COUNT_BYTES + 8


def table_rows(rows: int, compact_bytes: int) -> int:
    """Entries of the row-offset table at the head of the compacted region
    (``table_rows`` in the CUDA source)."""
    return min(rows, compact_bytes // MIN_HELD_BYTES)


def cta_held(nnz, plan) -> tuple[int, bool]:
    """Given a CTA's rows' nonzero counts, ``(held, compacted)``: the rows it
    holds in shared memory (its first ``held``; the rest stream each round)
    and whether in compacted form. The CTA places rows in order while their
    compacted sizes fit beside the table, and compacts when that holds more
    rows than the dense form's ``plan.cached``."""
    dense = min(plan.cached, len(nnz))
    table = table_rows(plan.rows, plan.compact_bytes)
    budget = plan.compact_bytes - 4 * table
    used = held = 0
    for n in nnz[:table]:
        used += fops._compact_row_bytes(int(n))
        if used > budget:
            break
        held += 1
    return (held, True) if held > dense else (dense, False)

"""The least bytes a query's plan needs, and the card's peaks.

A basic graph pattern runs as a left-deep chain of joins in the program's
scan order. Each join reads its two inputs once and writes its output
once; DISTINCT, where the query asks for it, reads the projected rows
once and writes the answer once.
Every id is 4 bytes, and a relation holds only the variables something
downstream still reads (the projection and the scans not yet joined), so
no plan with this scan order can move fewer bytes. Row counts are the
program's own: each scan's matches and each join's exact total. The count
never depends on which kernels did the work.
"""
from __future__ import annotations

ID_BYTES = 4
# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W limit
H100_HBM_BYTES_PER_S = 3.35e12


def _vars(pattern) -> list[str]:
    out = []
    for t in pattern:
        if t.startswith("?") and t not in out:
            out.append(t)
    return out


def plan_bytes(order, scan_rows, join_totals, select, result_rows,
               distinct=True) -> "int | None":
    """Bytes of the chain `order` (patterns in scan order, terms in full),
    with `scan_rows[i]` matches of order[i], `join_totals[j]` rows out of
    join j, projecting `select` (with DISTINCT to `result_rows` rows where
    `distinct`). None when the totals do not fit a chain over `order`."""
    if len(join_totals) != len(order) - 1:
        return None
    width = len(select) * ID_BYTES
    later = [set(select).union(*(_vars(p) for p in order[i + 1:]))
             for i in range(len(order))]
    bound = [v for v in _vars(order[0]) if v in later[0]]
    rows = scan_rows[0]
    moved = 0
    for j, total in enumerate(join_totals):
        # the right side's keys and what is read after this join
        right = [v for v in _vars(order[j + 1])
                 if v in bound or v in later[j + 1]]
        moved += ID_BYTES * (rows * len(bound) + scan_rows[j + 1] * len(right))
        bound = [v for v in bound + [v for v in right if v not in bound]
                 if v in later[j + 1]]
        rows = total
        moved += ID_BYTES * rows * len(bound)
    if distinct:
        moved += rows * width + result_rows * width
    return moved

"""BGP join-order planner — the paper's "CPU assigns subqueries" half.

The coprocessing strategy of MapSQ puts query planning on the CPU and join
execution on the accelerator. Here the host picks a left-deep join order by
greedy estimated cardinality (smallest pattern first, then the connected
pattern minimising the estimated intermediate size), and the device executes
the resulting chain of MapReduce joins.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    s: str  # variable "?x" or constant term
    p: str
    o: str

    def variables(self) -> tuple[str, ...]:
        return tuple(t for t in (self.s, self.p, self.o) if t.startswith("?"))

    def constants(self) -> tuple[tuple[str, str], ...]:
        out = []
        for pos, t in zip("spo", (self.s, self.p, self.o)):
            if not t.startswith("?"):
                out.append((pos, t))
        return tuple(out)


@dataclasses.dataclass
class JoinStep:
    pattern_index: int  # index into the BGP's pattern list
    key_vars: tuple[str, ...]  # join variables with the accumulated result
    is_cross: bool


def plan_bgp(
    patterns: Sequence[TriplePattern],
    cardinality: Callable[[TriplePattern], float],
) -> list[JoinStep]:
    """Greedy left-deep plan. `cardinality` estimates pattern match counts.

    Heuristic: start from the most selective pattern; repeatedly add the
    connected pattern with the smallest estimated cardinality (ties broken
    by more shared variables = more selective join). Disconnected components
    fall back to cross joins, taken last.
    """
    remaining = list(range(len(patterns)))
    remaining.sort(key=lambda i: cardinality(patterns[i]))
    first = remaining.pop(0)
    steps = [JoinStep(first, (), False)]
    bound: set[str] = set(patterns[first].variables())
    while remaining:
        connected = [
            i for i in remaining if set(patterns[i].variables()) & bound
        ]
        if connected:
            nxt = min(
                connected,
                key=lambda i: (
                    cardinality(patterns[i]),
                    -len(set(patterns[i].variables()) & bound),
                ),
            )
            key_vars = tuple(
                v for v in patterns[nxt].variables() if v in bound
            )
            steps.append(JoinStep(nxt, key_vars, False))
        else:
            # disconnected component: cross join. Pick the smallest pattern
            # by estimated cardinality (not input order) so the product
            # capacity of the cross-join intermediate stays minimal.
            nxt = min(remaining, key=lambda i: cardinality(patterns[i]))
            steps.append(JoinStep(nxt, (), True))
        bound |= set(patterns[nxt].variables())
        remaining.remove(nxt)
    return steps

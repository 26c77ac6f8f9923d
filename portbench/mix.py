"""The one generator of requests: reads a traffic mix file and turns it
into query texts for the program, patterns for the reference, and each
client's sequence of requests, drawn from the seed.

A mix file holds `clients` (closed-loop clients), `prefixes`, and
`templates`, each with a `name`, a `select` list of variables, `distinct`,
a `where` list of [s, p, o] terms (variables, `a`, `prefix:local` or full
terms) and an optional integer `weight` (copies in each shuffled block).
Each client sends the templates in seeded shuffles of one block after
another, so every seed sends the same mix in another order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import expand


@dataclasses.dataclass(frozen=True)
class Template:
    name: str
    text: str  # the SPARQL the program is sent
    patterns: tuple[tuple[str, str, str], ...]  # terms in full
    select: tuple[str, ...]
    distinct: bool


def templates(traffic: dict) -> list[Template]:
    prefixes = traffic.get("prefixes", {})
    head = "".join(f"PREFIX {k}: <{v}>\n" for k, v in prefixes.items())
    out = []
    for t in traffic["templates"]:
        where = " .\n  ".join(" ".join(tp) for tp in t["where"])
        select = " ".join(t["select"])
        distinct = bool(t.get("distinct", False))
        text = (f"{head}SELECT {'DISTINCT ' if distinct else ''}{select} "
                f"WHERE {{\n  {where} .\n}}")
        out.append(Template(
            name=t["name"],
            text=text,
            patterns=tuple(tuple(expand(x, prefixes) for x in tp)
                           for tp in t["where"]),
            select=tuple(t["select"]),
            distinct=distinct,
        ))
    return out


def client_sequence(traffic: dict, seed: int, client: int):
    """An endless iterator of template indexes for one client."""
    block = [i for i, t in enumerate(traffic["templates"])
             for _ in range(int(t.get("weight", 1)))]
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), client])
    while True:
        yield from (block[k] for k in rng.permutation(len(block)))

"""Logical query algebra: the tree the parser emits and the planner consumes.

The prepared-query API layers the stack as

    text --parse--> logical algebra --plan--> physical plan --compile--> XLA

This module is the middle layer: a small, frozen, hashable tree of SPARQL
operators (BGP / Join / Union / LeftJoin / Filter / Project / Distinct /
Slice) covering the query class the paper's successors evaluate (gSMat,
gSmart: filtered, optional and union basic graph patterns). Every planner
feature — including the rewrite passes in sparql/optimizer.py — targets
this tree instead of ad-hoc pattern lists.

Supported FILTER expressions are boolean combinations (`&&`, `||`,
parentheses) of comparisons whose left side is a variable:

    ?x != ?y          term (id) comparison, both sides must be bound
    ?age >= 21        numeric comparison against an integer/decimal literal
    ?n = "alice"      term comparison against a string literal or IRI

SPARQL's error semantics apply: a comparison involving an unbound variable
or a non-numeric value under a numeric operator is an error, and an error
fails that comparison (even for `!=`). With only `&&`/`||` and no negation
operator, collapsing error to false at the leaves is observationally
equivalent to full three-valued logic (err && x = false = removed;
err || true = true either way), which is what the device masks do.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core.planner import TriplePattern

COMPARE_OPS = ("=", "!=", "<", "<=", ">", ">=")
ORDERING_OPS = ("<", "<=", ">", ">=")


# -- filter expression operands ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class Var:
    name: str  # "?x"


@dataclasses.dataclass(frozen=True)
class NumLit:
    """Integer or decimal literal; compared by numeric value."""

    value: float
    lexical: str  # as written, e.g. "42" or "3.5"


@dataclasses.dataclass(frozen=True)
class TermLit:
    """IRI or quoted string literal; compared by term identity."""

    lexical: str  # resolved form, e.g. '<http://...>' or '"alice"'


Operand = Union[Var, NumLit, TermLit]


@dataclasses.dataclass(frozen=True)
class Compare:
    lhs: str  # variable name
    op: str  # one of COMPARE_OPS
    rhs: Operand

    def variables(self) -> tuple[str, ...]:
        if isinstance(self.rhs, Var):
            return (self.lhs, self.rhs.name)
        return (self.lhs,)

    def __str__(self) -> str:
        if isinstance(self.rhs, Var):
            rhs = self.rhs.name
        elif isinstance(self.rhs, NumLit):
            rhs = self.rhs.lexical
        else:
            rhs = self.rhs.lexical
        return f"{self.lhs} {self.op} {rhs}"


@dataclasses.dataclass(frozen=True)
class And:
    """Conjunction of filter expressions (FILTER `&&`)."""

    children: tuple["FilterExpr", ...]

    def variables(self) -> tuple[str, ...]:
        return _expr_vars(self.children)

    def __str__(self) -> str:
        return " && ".join(_paren(c) for c in self.children)


@dataclasses.dataclass(frozen=True)
class Or:
    """Disjunction of filter expressions (FILTER `||`)."""

    children: tuple["FilterExpr", ...]

    def variables(self) -> tuple[str, ...]:
        return _expr_vars(self.children)

    def __str__(self) -> str:
        return " || ".join(_paren(c) for c in self.children)


FilterExpr = Union[Compare, And, Or]


def _expr_vars(children) -> tuple[str, ...]:
    out: list[str] = []
    for c in children:
        for v in c.variables():
            if v not in out:
                out.append(v)
    return tuple(out)


def _paren(expr: "FilterExpr") -> str:
    return f"({expr})" if isinstance(expr, (And, Or)) else str(expr)


def flatten_conjuncts(expr: "FilterExpr") -> tuple["FilterExpr", ...]:
    """Split top-level ANDs into the conjunct list the optimizer pushes
    around independently (an Or conjunct stays one opaque unit)."""
    if isinstance(expr, And):
        out: list[FilterExpr] = []
        for c in expr.children:
            out.extend(flatten_conjuncts(c))
        return tuple(out)
    return (expr,)


# -- algebra nodes ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BGP:
    patterns: tuple[TriplePattern, ...]

    def variables(self) -> tuple[str, ...]:
        out: list[str] = []
        for tp in self.patterns:
            for v in tp.variables():
                if v not in out:
                    out.append(v)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Join:
    """Inner join of two subtrees (required BGP joined with a UNION block)."""

    left: "AlgebraNode"
    right: "AlgebraNode"

    def variables(self) -> tuple[str, ...]:
        out = list(self.left.variables())
        for v in self.right.variables():
            if v not in out:
                out.append(v)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class UnionNode:
    """SPARQL UNION: multiset union of branch solutions. Branches may bind
    different variables; a row leaves the other branches' variables unbound."""

    branches: tuple["AlgebraNode", ...]

    def variables(self) -> tuple[str, ...]:
        out: list[str] = []
        for b in self.branches:
            for v in b.variables():
                if v not in out:
                    out.append(v)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class LeftJoin:
    """OPTIONAL: keep every left row; extend with right bindings when the
    optional group matches, leave its variables unbound otherwise."""

    left: "AlgebraNode"
    right: BGP

    def variables(self) -> tuple[str, ...]:
        out = list(self.left.variables())
        for v in self.right.variables():
            if v not in out:
                out.append(v)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Filter:
    child: "AlgebraNode"
    conditions: tuple[FilterExpr, ...]  # conjunction of expressions

    def variables(self) -> tuple[str, ...]:
        return self.child.variables()


@dataclasses.dataclass(frozen=True)
class Project:
    child: "AlgebraNode"
    vars: tuple[str, ...]

    def variables(self) -> tuple[str, ...]:
        return self.vars


@dataclasses.dataclass(frozen=True)
class Distinct:
    child: "AlgebraNode"

    def variables(self) -> tuple[str, ...]:
        return self.child.variables()


@dataclasses.dataclass(frozen=True)
class Slice:
    child: "AlgebraNode"
    offset: int
    limit: int | None  # None: no LIMIT (OFFSET-only slice)

    def variables(self) -> tuple[str, ...]:
        return self.child.variables()


AlgebraNode = Union[
    BGP, Join, UnionNode, LeftJoin, Filter, Project, Distinct, Slice
]


# -- update surface (SPARQL Update ground-data operations) --------------------


@dataclasses.dataclass(frozen=True)
class InsertData:
    """INSERT DATA { ... }: ground triples appended to the store's mutable
    delta tail. Triples are TriplePatterns with no variables (the parser
    enforces groundness)."""

    triples: tuple[TriplePattern, ...]


@dataclasses.dataclass(frozen=True)
class DeleteData:
    """DELETE DATA { ... }: ground triples removed from the store — matching
    tail rows drop immediately, matching base rows are tombstoned until the
    next compaction."""

    triples: tuple[TriplePattern, ...]


UpdateOp = Union[InsertData, DeleteData]


def format_update(ops: tuple[UpdateOp, ...]) -> str:
    """One line per operation, mirroring format_algebra's report style."""
    lines = []
    for op in ops:
        kind = "InsertData" if isinstance(op, InsertData) else "DeleteData"
        lines.append(f"{kind}({len(op.triples)} triple(s))")
    return "\n".join(lines)


def format_algebra(node: AlgebraNode, indent: int = 0) -> str:
    """Indented one-node-per-line rendering (used by PreparedQuery.explain)."""
    pad = "  " * indent
    if isinstance(node, BGP):
        lines = [f"{pad}BGP"]
        lines += [
            f"{pad}  ({tp.s} {tp.p} {tp.o})" for tp in node.patterns
        ]
        return "\n".join(lines)
    if isinstance(node, Join):
        return (
            f"{pad}Join\n"
            + format_algebra(node.left, indent + 1)
            + "\n"
            + format_algebra(node.right, indent + 1)
        )
    if isinstance(node, UnionNode):
        return f"{pad}Union\n" + "\n".join(
            format_algebra(b, indent + 1) for b in node.branches
        )
    if isinstance(node, LeftJoin):
        return (
            f"{pad}LeftJoin (OPTIONAL)\n"
            + format_algebra(node.left, indent + 1)
            + "\n"
            + format_algebra(node.right, indent + 1)
        )
    if isinstance(node, Filter):
        conds = " && ".join(str(c) for c in node.conditions)
        return f"{pad}Filter({conds})\n" + format_algebra(node.child, indent + 1)
    if isinstance(node, Project):
        return (
            f"{pad}Project({', '.join(node.vars)})\n"
            + format_algebra(node.child, indent + 1)
        )
    if isinstance(node, Distinct):
        return f"{pad}Distinct\n" + format_algebra(node.child, indent + 1)
    if isinstance(node, Slice):
        limit = "-" if node.limit is None else node.limit
        return (
            f"{pad}Slice(offset={node.offset}, limit={limit})\n"
            + format_algebra(node.child, indent + 1)
        )
    raise TypeError(f"unknown algebra node {node!r}")

"""SPARQL parser: PREFIX / SELECT [DISTINCT] / WHERE / LIMIT / OFFSET.

Covers the query class the paper (basic graph patterns with variables,
IRIs, prefixed names, literals, `;` predicate-object lists) and its
successors evaluate: FILTER expressions (comparisons over numeric and
string literals or variables, combined with `&&`, `||` and parentheses),
OPTIONAL groups, `{ .. } UNION { .. }` blocks, `#` line comments,
integer/decimal literals, and LIMIT/OFFSET solution modifiers. Parsing is
host-side — part of the CPU half of the coprocessing strategy.

The result is a `Query`: the WHERE group decomposed into a required BGP,
OPTIONAL groups, UNION branches and filter conjuncts, plus the solution
modifiers. `Query.algebra()` assembles the logical-algebra tree
(sparql/algebra.py) that the optimizer rewrites and the engine compiles.

`parse_update` covers the write side of the protocol: a SPARQL Update
request of one or more `INSERT DATA { ... }` / `DELETE DATA { ... }`
operations (ground triples only, `;`-separated, shared PREFIX prologue),
returned as an `UpdateRequest` of algebra.InsertData / algebra.DeleteData
ops in request order — the input `QueryEngine.update` applies against the
store's delta blocks.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.core.planner import TriplePattern
from repro_torch.sparql import algebra

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<var>\?[A-Za-z_][\w]*)
      | (?P<iri><[^>\s]*>)
      | (?P<literal>"(?:[^"\\]|\\.)*")
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<pname>[A-Za-z_][\w\-]*:[A-Za-z_][\w\-]*)
      | (?P<pdecl>[A-Za-z_][\w\-]*:)
      | (?P<op><=|>=|!=|&&|\|\||[=<>()])
      | (?P<kw>PREFIX|SELECT|DISTINCT|WHERE|FILTER|OPTIONAL|UNION|LIMIT
              |OFFSET|INSERT|DELETE|DATA|\{|\}|\.|;|\*|a\b)
    )""",
    re.VERBOSE | re.IGNORECASE,
)

_NUM = re.compile(r"-?\d+(?:\.\d+)?")

_RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"


@dataclasses.dataclass
class Query:
    select_vars: list[str]  # empty => SELECT *
    distinct: bool
    patterns: list[TriplePattern]  # the required BGP (may be empty if unions)
    optionals: tuple[tuple[TriplePattern, ...], ...] = ()
    filters: tuple[algebra.FilterExpr, ...] = ()  # conjunct list
    limit: int | None = None
    offset: int = 0
    unions: tuple[tuple[TriplePattern, ...], ...] = ()  # UNION branches

    def all_vars(self) -> list[str]:
        out: list[str] = []

        def add(group) -> None:
            for tp in group:
                for v in tp.variables():
                    if v not in out:
                        out.append(v)

        add(self.patterns)
        for branch in self.unions:
            add(branch)
        for group in self.optionals:
            add(group)
        return out

    def projection(self) -> list[str]:
        return self.select_vars or self.all_vars()

    def has_slice(self) -> bool:
        return self.limit is not None or self.offset > 0

    def algebra(self) -> algebra.AlgebraNode:
        """Assemble the logical tree: BGP [⋈ Union] → LeftJoin* → Filter
        → Project → Distinct → Slice."""
        node: algebra.AlgebraNode | None = (
            algebra.BGP(tuple(self.patterns)) if self.patterns else None
        )
        if self.unions:
            u = algebra.UnionNode(
                tuple(algebra.BGP(b) for b in self.unions)
            )
            node = algebra.Join(node, u) if node is not None else u
        assert node is not None  # parser guarantees patterns or unions
        for group in self.optionals:
            node = algebra.LeftJoin(node, algebra.BGP(group))
        if self.filters:
            node = algebra.Filter(node, self.filters)
        node = algebra.Project(node, tuple(self.projection()))
        if self.distinct:
            node = algebra.Distinct(node)
        if self.has_slice():
            node = algebra.Slice(node, self.offset, self.limit)
        return node


class ParseError(ValueError):
    pass


def _tokenize(text: str) -> list[str]:
    tokens, pos = [], 0
    while pos < len(text):
        if text[pos:].strip() == "":
            break
        m = _TOKEN.match(text, pos)
        if not m:
            raise ParseError(f"unexpected input at: {text[pos:pos + 30]!r}")
        if m.lastgroup != "comment":  # `#` line comments are skipped
            tokens.append(m.group(0).strip())
        pos = m.end()
    return tokens


def parse(text: str) -> Query:
    tokens = _tokenize(text)
    i = 0
    prefixes: dict[str, str] = {}

    def peek() -> str:
        return tokens[i] if i < len(tokens) else ""

    def eat(expect: str | None = None) -> str:
        nonlocal i
        if i >= len(tokens):
            raise ParseError(f"unexpected end of query (wanted {expect})")
        tok = tokens[i]
        if expect and tok.upper() != expect.upper():
            raise ParseError(f"expected {expect}, got {tok!r}")
        i += 1
        return tok

    while peek().upper() == "PREFIX":
        eat()
        pname = eat()
        if not pname.endswith(":"):
            raise ParseError(f"malformed PREFIX declaration near {pname!r}")
        iri = eat()
        if not (iri.startswith("<") and iri.endswith(">")):
            raise ParseError(f"PREFIX needs an IRI, got {iri!r}")
        prefixes[pname[:-1]] = iri[1:-1]

    eat("SELECT")
    distinct = False
    if peek().upper() == "DISTINCT":
        eat()
        distinct = True
    select_vars: list[str] = []
    if peek() == "*":
        eat()
    else:
        while peek().startswith("?"):
            select_vars.append(eat())
        if not select_vars:
            raise ParseError("SELECT needs variables or *")
    eat("WHERE")
    eat("{")

    def resolve(tok: str) -> str:
        if tok.startswith("?"):
            return tok
        if tok == "a":
            return _RDF_TYPE
        if tok.startswith("<") or tok.startswith('"') or _NUM.fullmatch(tok):
            return tok
        ns, colon, local = tok.partition(":")
        if not colon or ns not in prefixes:
            raise ParseError(f"unknown prefix {ns!r} in {tok!r}")
        return f"<{prefixes[ns]}{local}>"

    def parse_triples_into(dest: list[TriplePattern]) -> None:
        s = resolve(eat())
        dest.append(TriplePattern(s, resolve(eat()), resolve(eat())))
        # `;` predicate-object lists: `?x a ub:Student ; ub:memberOf ?d .`
        while peek() == ";":
            eat()
            if peek() in (".", "}"):  # dangling `;` before a terminator
                break
            dest.append(TriplePattern(s, resolve(eat()), resolve(eat())))

    def parse_operand() -> algebra.Operand:
        tok = eat()
        if tok.startswith("?"):
            return algebra.Var(tok)
        if _NUM.fullmatch(tok):
            return algebra.NumLit(float(tok), tok)
        return algebra.TermLit(resolve(tok))

    def parse_compare() -> algebra.Compare:
        lhs = parse_operand()
        if not isinstance(lhs, algebra.Var):
            raise ParseError(
                "FILTER comparisons must have a variable on the left"
            )
        op = eat()
        if op not in algebra.COMPARE_OPS:
            raise ParseError(f"expected a comparison operator, got {op!r}")
        rhs = parse_operand()
        if op in algebra.ORDERING_OPS and isinstance(rhs, algebra.TermLit):
            raise ParseError(
                f"ordering comparison {op!r} needs a numeric literal or "
                f"variable, got {rhs.lexical!r}"
            )
        return algebra.Compare(lhs.name, op, rhs)

    # FILTER expression grammar (|| binds loosest, && tighter, parens):
    #   expr    := and_exp ("||" and_exp)*
    #   and_exp := primary ("&&" primary)*
    #   primary := "(" expr ")" | comparison
    def parse_filter_expr() -> algebra.FilterExpr:
        terms = [parse_and_expr()]
        while peek() == "||":
            eat()
            terms.append(parse_and_expr())
        return algebra.Or(tuple(terms)) if len(terms) > 1 else terms[0]

    def parse_and_expr() -> algebra.FilterExpr:
        factors = [parse_primary()]
        while peek() == "&&":
            eat()
            factors.append(parse_primary())
        return algebra.And(tuple(factors)) if len(factors) > 1 else factors[0]

    def parse_primary() -> algebra.FilterExpr:
        if peek() == "(":
            eat()
            inner = parse_filter_expr()
            eat(")")
            return inner
        return parse_compare()

    def parse_group(dest: list[TriplePattern], what: str) -> None:
        """A braced block of plain triples (OPTIONAL / UNION bodies)."""
        eat("{")
        while peek() != "}":
            if peek().upper() in ("OPTIONAL", "FILTER", "UNION", "{"):
                raise ParseError(
                    f"nested OPTIONAL/FILTER/UNION inside {what} "
                    "is not supported"
                )
            parse_triples_into(dest)
            if peek() == ".":
                eat()
        eat("}")
        if not dest:
            raise ParseError(f"empty {what}")

    patterns: list[TriplePattern] = []
    optionals: list[tuple[TriplePattern, ...]] = []
    unions: list[tuple[TriplePattern, ...]] = []
    filters: list[algebra.FilterExpr] = []
    while peek() != "}":
        head = peek().upper()
        if head == "OPTIONAL":
            eat()
            block: list[TriplePattern] = []
            parse_group(block, "an OPTIONAL group")
            optionals.append(tuple(block))
        elif head == "FILTER":
            eat()
            eat("(")
            expr = parse_filter_expr()
            eat(")")
            # top-level conjunctions split into independently pushable
            # conjuncts (keeps the historical flat `filters` shape)
            filters.extend(algebra.flatten_conjuncts(expr))
        elif head == "{":
            # { branch } UNION { branch } [UNION { branch }]*
            if unions:
                raise ParseError(
                    "only one UNION block per query is supported"
                )
            branch: list[TriplePattern] = []
            parse_group(branch, "a UNION branch")
            unions.append(tuple(branch))
            if peek().upper() != "UNION":
                raise ParseError("a braced group must be part of a UNION")
            while peek().upper() == "UNION":
                eat()
                branch = []
                parse_group(branch, "a UNION branch")
                unions.append(tuple(branch))
        else:
            parse_triples_into(patterns)
        if peek() == ".":
            eat()
    eat("}")

    limit: int | None = None
    offset = 0
    seen_mods: set[str] = set()
    while peek().upper() in ("LIMIT", "OFFSET"):
        kw = eat().upper()
        if kw in seen_mods:
            raise ParseError(f"duplicate {kw}")
        seen_mods.add(kw)
        val = eat()
        if not re.fullmatch(r"\d+", val):
            raise ParseError(f"{kw} needs a non-negative integer, got {val!r}")
        if kw == "LIMIT":
            limit = int(val)
        else:
            offset = int(val)
    if peek():
        raise ParseError(f"trailing input after query: {peek()!r}")

    if not patterns and not unions:
        raise ParseError("empty basic graph pattern")
    if unions and optionals:
        raise ParseError(
            "OPTIONAL together with UNION in one query is not supported"
        )
    q = Query(
        select_vars,
        distinct,
        patterns,
        tuple(optionals),
        tuple(filters),
        limit,
        offset,
        tuple(unions),
    )
    bound = set(q.all_vars())
    unknown = [v for v in select_vars if v not in bound]
    if unknown:
        raise ParseError(f"SELECT vars not in WHERE clause: {unknown}")
    for cond in filters:
        loose = [v for v in cond.variables() if v not in bound]
        if loose:
            raise ParseError(f"FILTER vars not in WHERE clause: {loose}")
    return q


# -- SPARQL Update ------------------------------------------------------------


@dataclasses.dataclass
class UpdateRequest:
    """A parsed update: InsertData / DeleteData ops in request order."""

    ops: tuple[algebra.UpdateOp, ...]

    def n_triples(self) -> int:
        return sum(len(op.triples) for op in self.ops)


def parse_update(text: str) -> UpdateRequest:
    """Parse `INSERT DATA { ... }` / `DELETE DATA { ... }` operations.

    Grammar (the ground-data subset of SPARQL 1.1 Update):

        update  := PREFIX* op ( ';' op )* ';'?
        op      := ('INSERT' | 'DELETE') 'DATA' '{' triples '}'

    Data blocks hold ground triples only — variables (and the braces of
    GRAPH blocks) are rejected. `a` and `;` predicate-object lists resolve
    exactly as in queries; the shared PREFIX prologue applies to every op.
    """
    tokens = _tokenize(text)
    i = 0
    prefixes: dict[str, str] = {}

    def peek() -> str:
        return tokens[i] if i < len(tokens) else ""

    def eat(expect: str | None = None) -> str:
        nonlocal i
        if i >= len(tokens):
            raise ParseError(f"unexpected end of update (wanted {expect})")
        tok = tokens[i]
        if expect and tok.upper() != expect.upper():
            raise ParseError(f"expected {expect}, got {tok!r}")
        i += 1
        return tok

    while peek().upper() == "PREFIX":
        eat()
        pname = eat()
        if not pname.endswith(":"):
            raise ParseError(f"malformed PREFIX declaration near {pname!r}")
        iri = eat()
        if not (iri.startswith("<") and iri.endswith(">")):
            raise ParseError(f"PREFIX needs an IRI, got {iri!r}")
        prefixes[pname[:-1]] = iri[1:-1]

    def resolve(tok: str) -> str:
        if tok.startswith("?"):
            raise ParseError(
                f"variables are not allowed in DATA blocks: {tok!r}"
            )
        if tok == "a":
            return _RDF_TYPE
        if tok.startswith("<") or tok.startswith('"') or _NUM.fullmatch(tok):
            return tok
        ns, colon, local = tok.partition(":")
        if not colon or ns not in prefixes:
            raise ParseError(f"unknown prefix {ns!r} in {tok!r}")
        return f"<{prefixes[ns]}{local}>"

    def parse_data_block() -> tuple[TriplePattern, ...]:
        eat("{")
        triples: list[TriplePattern] = []
        while peek() != "}":
            s = resolve(eat())
            triples.append(TriplePattern(s, resolve(eat()), resolve(eat())))
            while peek() == ";":  # predicate-object lists share the subject
                eat()
                if peek() in (".", "}"):
                    break
                triples.append(
                    TriplePattern(s, resolve(eat()), resolve(eat()))
                )
            if peek() == ".":
                eat()
        eat("}")
        if not triples:
            raise ParseError("empty DATA block")
        return tuple(triples)

    ops: list[algebra.UpdateOp] = []
    while True:
        head = eat().upper()
        if head not in ("INSERT", "DELETE"):
            raise ParseError(
                f"expected INSERT DATA or DELETE DATA, got {head!r}"
            )
        eat("DATA")
        block = parse_data_block()
        ops.append(
            algebra.InsertData(block) if head == "INSERT"
            else algebra.DeleteData(block)
        )
        if peek() == ";":
            eat()
            if not peek():  # trailing `;` after the last op is legal
                break
            continue
        break
    if peek():
        raise ParseError(f"trailing input after update: {peek()!r}")
    return UpdateRequest(tuple(ops))

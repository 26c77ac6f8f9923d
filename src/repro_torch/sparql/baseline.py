"""Join baselines standing in for gStore / gStoreD's CPU joins (Table 2).

The paper compares MapSQ's GPU MapReduce join against the join operation of
two CPU engines. gStore itself isn't available (C++/CPU), so we implement
the comparison class faithfully:

  * nested_loop_join   — the "plain join algorithm" the paper names;
    classic tuple-at-a-time CPU nested loop (host numpy, O(n·m)).
  * hash_join          — build/probe hash join, the standard CPU engine
    join (host python dict, O(n+m)); stands in for gStore.
  * partitioned_hash_join — hash-partitioned two-phase variant standing in
    for the distributed gStoreD (partition overhead + per-partition probe).

All three consume/produce the same dictionary-encoded numpy rows as the
device join, so benchmarks/bench_join.py can reproduce the Table 2 shape:
same partial matches in, same result set out, join time compared.

`reference_rows` additionally evaluates a full parsed Query — BGP, UNION,
OPTIONAL, FILTER (boolean combinations), projection, DISTINCT — by
backtracking over decoded triples. It is the differential oracle the prepared-query tests compare
the device algebra against (LIMIT/OFFSET are left to the caller, since
any row subset of the right size is a correct slice).
"""
from __future__ import annotations

import re

import numpy as np


def _key_cols(schema_l, schema_r):
    shared = [v for v in schema_l if v in schema_r]
    li = [schema_l.index(v) for v in shared]
    ri = [schema_r.index(v) for v in shared]
    r_extra = [i for i, v in enumerate(schema_r) if v not in schema_l]
    out_schema = tuple(schema_l) + tuple(schema_r[i] for i in r_extra)
    return li, ri, r_extra, out_schema


def nested_loop_join(schema_l, rows_l: np.ndarray, schema_r,
                     rows_r: np.ndarray):
    """Tuple-at-a-time nested loop (the paper's 'plain join algorithm')."""
    li, ri, r_extra, out_schema = _key_cols(schema_l, schema_r)
    out = []
    for a in rows_l:
        ka = tuple(a[i] for i in li)
        for b in rows_r:
            if ka == tuple(b[i] for i in ri):
                out.append(list(a) + [b[i] for i in r_extra])
    return out_schema, np.asarray(out, np.int32).reshape(-1, len(out_schema))


def hash_join(schema_l, rows_l: np.ndarray, schema_r, rows_r: np.ndarray):
    """Build (left) + probe (right) hash join — the gStore stand-in."""
    li, ri, r_extra, out_schema = _key_cols(schema_l, schema_r)
    table: dict[tuple, list] = {}
    for a in rows_l:
        table.setdefault(tuple(a[i] for i in li), []).append(a)
    out = []
    for b in rows_r:
        for a in table.get(tuple(b[i] for i in ri), ()):
            out.append(list(a) + [b[i] for i in r_extra])
    return out_schema, np.asarray(out, np.int32).reshape(-1, len(out_schema))


_NUMERIC = re.compile(r"-?\d+(?:\.\d+)?")


def _term_numeric(term: str):
    """Numeric value of a term lexical, at the engine's documented float32
    precision (the device FILTER path gathers a float32 table, so integers
    beyond 2^24 compare by their rounded value — the oracle must agree)."""
    return np.float32(term) if _NUMERIC.fullmatch(term) else None


def _extend(bindings: list[dict], triples, tp) -> list[dict]:
    """All extensions of each binding by one triple pattern (backtracking)."""
    out = []
    for b in bindings:
        for s, p, o in triples:
            nb = dict(b)
            ok = True
            for term, val in ((tp.s, s), (tp.p, p), (tp.o, o)):
                if term.startswith("?"):
                    if nb.get(term, val) != val:
                        ok = False
                        break
                    nb[term] = val
                elif term != val:
                    ok = False
                    break
            if ok:
                out.append(nb)
    return out


def _filter_true(cond, b: dict) -> bool:
    """SPARQL error semantics: unbound operands or non-numeric values under
    numeric operators fail the condition (even for !=). `cond` may be a
    boolean combination (algebra.And / algebra.Or) of comparisons."""
    from repro_torch.sparql import algebra

    if isinstance(cond, algebra.And):
        return all(_filter_true(c, b) for c in cond.children)
    if isinstance(cond, algebra.Or):
        return any(_filter_true(c, b) for c in cond.children)
    lhs = b.get(cond.lhs)
    if lhs is None:
        return False
    if isinstance(cond.rhs, algebra.Var):
        rhs = b.get(cond.rhs.name)
        if rhs is None:
            return False
        if cond.op in ("=", "!="):
            return (lhs == rhs) if cond.op == "=" else (lhs != rhs)
        lv, rv = _term_numeric(lhs), _term_numeric(rhs)
        if lv is None or rv is None:
            return False
    elif isinstance(cond.rhs, algebra.NumLit):
        lv, rv = _term_numeric(lhs), np.float32(cond.rhs.value)
        if lv is None:
            return False
    else:  # TermLit: identity comparison
        if cond.op == "=":
            return lhs == cond.rhs.lexical
        if cond.op == "!=":
            return lhs != cond.rhs.lexical
        return False
    return {
        "=": lv == rv, "!=": lv != rv, "<": lv < rv,
        "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv,
    }[cond.op]


def reference_rows(store, q) -> list[dict[str, str]]:
    """Pure-python oracle for the logical algebra (everything but the
    slice): projected rows as {var: term} dicts, unbound vars omitted."""
    d = store.dictionary
    triples = [tuple(d.decode(int(t)) for t in row) for row in store.triples]
    bindings = [dict()]
    for tp in q.patterns:
        bindings = _extend(bindings, triples, tp)
    if getattr(q, "unions", ()):
        # multiset union: each branch extends the required bindings
        # independently; rows keep other branches' variables unbound
        unioned: list[dict] = []
        for branch in q.unions:
            ext = list(bindings)
            for tp in branch:
                ext = _extend(ext, triples, tp)
            unioned.extend(ext)
        bindings = unioned
    for group in q.optionals:
        joined = []
        for b in bindings:
            ext = [b]
            for tp in group:
                ext = _extend(ext, triples, tp)
            joined.extend(ext if ext else [b])  # no match: keep b unextended
        bindings = joined
    for cond in q.filters:
        bindings = [b for b in bindings if _filter_true(cond, b)]
    proj = q.projection()
    rows = [{v: b[v] for v in proj if v in b} for b in bindings]
    if q.distinct:
        seen, uniq = set(), []
        for r in rows:
            key = tuple(sorted(r.items()))
            if key not in seen:
                seen.add(key)
                uniq.append(r)
        rows = uniq
    return rows


def partitioned_hash_join(schema_l, rows_l, schema_r, rows_r,
                          n_parts: int = 4):
    """Grace-style partitioned hash join — the gStoreD stand-in (adds the
    partition pass a distributed engine pays before local joins)."""
    li, ri, r_extra, out_schema = _key_cols(schema_l, schema_r)

    def part(rows, idx):
        buckets = [[] for _ in range(n_parts)]
        for r in rows:
            buckets[hash(tuple(r[i] for i in idx)) % n_parts].append(r)
        return buckets

    bl = part(rows_l, li)
    br = part(rows_r, ri)
    out = []
    for p in range(n_parts):
        _, rows = hash_join(schema_l, np.asarray(bl[p], np.int32).reshape(
            -1, len(schema_l)), schema_r,
            np.asarray(br[p], np.int32).reshape(-1, len(schema_r)))
        out.append(rows)
    rows = np.concatenate(out) if out else np.zeros((0, len(out_schema)),
                                                    np.int32)
    return out_schema, rows

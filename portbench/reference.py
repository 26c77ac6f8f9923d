"""The plain reference: basic graph patterns over encoded triples, in NumPy.

Independent of the program under test: it imports NumPy and the standard
library only, parses nothing of SPARQL (it takes the templates' patterns as
data), and works out its own scans, join order and join results from the
raw (n, 3) id array. Joins are sort-and-search equi-joins on every shared
variable; a left-deep order starting from the smallest scan, each step the
smallest connected scan. Columns nothing downstream reads are dropped after
each join. `distinct=True` applies set semantics to the projected rows;
`distinct=False` keeps the bag. `packed16=True` is the control: a join on
two or more variables compares one 32-bit key packed from each id's low
16 bits, below the whole int32 ids the configurations state.
"""
from __future__ import annotations

import numpy as np

RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"


def expand(term: str, prefixes: dict[str, str]) -> str:
    """A template term in full: variables and full IRIs or literals as
    they are, `a` as rdf:type, `prefix:local` against `prefixes`."""
    if term.startswith(("?", "<", '"')):
        return term
    if term == "a":
        return RDF_TYPE
    prefix, sep, local = term.partition(":")
    if not sep or prefix not in prefixes:
        raise ValueError(f"unknown prefix in {term!r}")
    return f"<{prefixes[prefix]}{local}>"


class Triples:
    """The triples grouped by predicate once, so a scan with a constant
    predicate slices one block instead of masking every row."""

    def __init__(self, triples: np.ndarray, terms: list[str]):
        t = np.asarray(triples, np.int32).reshape(-1, 3)
        order = np.argsort(t[:, 1], kind="stable")
        self.by_pred = t[order]
        self.preds, self.starts = np.unique(self.by_pred[:, 1],
                                            return_index=True)
        self.ends = np.append(self.starts[1:], len(t))
        self.terms = terms
        self._ids: dict[str, int] = {}

    def term_id(self, term: str) -> int:
        """The id of a constant, -1 when the data lacks it."""
        tid = self._ids.get(term)
        if tid is None:
            try:
                tid = self.terms.index(term)
            except ValueError:
                tid = -1
            self._ids[term] = tid
        return tid

    def scan(self, pattern: tuple[str, str, str]) -> tuple[list[str], np.ndarray]:
        """(variables, rows) of one triple pattern; a variable repeated in
        the pattern binds equal values."""
        s, p, o = pattern
        if p.startswith("?"):
            rows = self.by_pred
        else:
            k = np.searchsorted(self.preds, self.term_id(p))
            if k == len(self.preds) or self.preds[k] != self.term_id(p):
                rows = self.by_pred[:0]
            else:
                rows = self.by_pred[self.starts[k]:self.ends[k]]
        keep = np.ones(len(rows), bool)
        cols: dict[str, int] = {}
        for j, term in enumerate((s, p, o)):
            if not term.startswith("?"):
                keep &= rows[:, j] == self.term_id(term)
            elif term in cols:
                keep &= rows[:, j] == rows[:, cols[term]]
            else:
                cols[term] = j
        rows = rows[keep] if not keep.all() else rows
        return list(cols), np.ascontiguousarray(rows[:, list(cols.values())])


def _keys(lrows, lcols, rrows, rcols,
          packed16=False) -> tuple[np.ndarray, np.ndarray]:
    """One int64 key per row on each side, equal exactly where every
    shared column is equal (with `packed16` and two or more columns, where
    the low 16 bits of the first two are)."""
    n_l = len(lrows)
    if packed16 and len(lcols) > 1:
        def pack(rows, cols):
            a, b = (rows[:, c].astype(np.int64) & 0xFFFF for c in cols[:2])
            return (a << 16) | b
        return pack(lrows, lcols), pack(rrows, rcols)
    lk = np.zeros(n_l, np.int64)
    rk = np.zeros(len(rrows), np.int64)
    for k, (a, b) in enumerate(zip(lcols, rcols)):
        both = np.concatenate([lk, rk]) * (1 << 31)
        both += np.concatenate([lrows[:, a], rrows[:, b]]).astype(np.int64)
        if k + 1 < len(lcols):  # dense codes keep the next product small
            both = np.unique(both, return_inverse=True)[1].astype(np.int64)
        lk, rk = both[:n_l], both[n_l:]
    return lk, rk


def join(left: tuple[list[str], np.ndarray],
         right: tuple[list[str], np.ndarray],
         packed16: bool = False) -> tuple[list[str], np.ndarray]:
    """The equi-join of two relations on every variable they share."""
    lvars, lrows = left
    rvars, rrows = right
    shared = [v for v in lvars if v in rvars]
    lk, rk = _keys(lrows, [lvars.index(v) for v in shared],
                   rrows, [rvars.index(v) for v in shared], packed16)
    order = np.argsort(rk, kind="stable")
    sorted_rk = rk[order]
    lo = np.searchsorted(sorted_rk, lk, "left")
    count = np.searchsorted(sorted_rk, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), count)
    first = np.cumsum(count) - count
    ri = order[lo[li] + (np.arange(len(li)) - first[li])]
    extra = [j for j, v in enumerate(rvars) if v not in shared]
    rows = np.concatenate([lrows[li], rrows[ri][:, extra]], axis=1)
    return lvars + [rvars[j] for j in extra], rows


def evaluate(data: Triples, patterns: list[tuple[str, str, str]],
             select: list[str], distinct: bool = True,
             packed16: bool = False) -> np.ndarray:
    """Rows of ids, one column per variable of `select` (with its `?`), of
    the BGP `patterns` (terms in full)."""
    scans = [data.scan(p) for p in patterns]
    todo = sorted(range(len(scans)), key=lambda i: len(scans[i][1]))
    cur = scans[todo.pop(0)]
    while todo:
        bound = set(cur[0])
        nxt = min(todo, key=lambda i: (not bound & set(scans[i][0]),
                                       len(scans[i][1])))
        todo.remove(nxt)
        cur = join(cur, scans[nxt], packed16)
        needed = set(select).union(*(scans[i][0] for i in todo))
        keep = [j for j, v in enumerate(cur[0]) if v in needed]
        if len(keep) < len(cur[0]):
            cur = ([cur[0][j] for j in keep], cur[1][:, keep])
    vars_, rows = cur
    missing = [v for v in select if v not in vars_]
    if missing:
        raise ValueError(f"projected variables {missing} are not bound")
    rows = rows[:, [vars_.index(v) for v in select]]
    if distinct:
        rows = (np.unique(rows[:, 0])[:, None] if rows.shape[1] == 1
                else np.unique(rows, axis=0))
    return rows

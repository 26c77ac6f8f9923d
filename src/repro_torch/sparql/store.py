"""Indexed triple store — our stand-in for the paper's gStore black box.

Three sorted permutation indexes (SPO, POS, OSP) give a binary-search range
scan for any bound-prefix pattern; the scan result IS the paper's "partial
match" relation fed to the MapReduce join. Index build is host-side numpy
(load time); scans are O(log n) + slice.

For the compiled query pipeline the store additionally keeps scan results
*device-resident*: `match_pattern_device` uploads a pattern's partial-match
arrays once per device, at a bucketed (pow-2) capacity, and hands the same
device buffers to every later query with the same pattern structure — so
warm queries feed the compiled executor with zero host->device re-staging.
Every staging method takes the device explicitly; the engine passes its
own. A
host-side row cache backs `match_rows`, making repeated planning
(cardinality estimation) a dict lookup.

The store takes writes through a delta-block design (INSERT DATA / DELETE
DATA): the sorted indexes cover an immutable *base* block, inserted rows
live in a small mutable *tail*, and deleted base rows go into a *tombstone*
set until `compact()` folds everything back into a fresh base. A staged
scan block is the base matches (tombstoned rows retained but masked
invalid — the compiled program's validity masks apply the delete
device-side) followed by the tail matches, at a capacity floored by the
pattern's high-water mark; within a pow-2 bucket, writes change the
staged *contents* but never the *shape*, so plan caches and compiled
executables survive updates. Every committed write batch bumps the
monotonic `version`; scan-cache entries record the version they staged
and are evicted on first stale lookup.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.plan_ir import bucket_capacity, next_pow2
from repro_torch.core.planner import TriplePattern
from repro_torch.core.relation import Relation, pad_to
from repro_torch.sparql.dictionary import TermDict

# index order -> the permutation of (s, p, o) columns it sorts by
_INDEXES = {
    "spo": (0, 1, 2),
    "pos": (1, 2, 0),
    "osp": (2, 0, 1),
}
# bound-position tuple -> preferred index (longest sorted prefix bound)
_CHOICE = {
    (): "spo",
    ("s",): "spo",
    ("s", "p"): "spo",
    ("s", "p", "o"): "spo",
    ("p",): "pos",
    ("p", "o"): "pos",
    ("o",): "osp",
    ("s", "o"): "osp",
}


@dataclasses.dataclass(frozen=True)
class PredicateStats:
    """Per-predicate catalog row: triple count, distinct-term counts and
    degree-skew metrics.

    `max_s_degree` / `max_o_degree` are the largest per-subject fan-out /
    per-object fan-in inside the predicate; the averages derive from the
    counts. Their ratio (`s_skew` / `o_skew`) is the skew signal the
    optimizer combines with join selectivity to pick the matrix join
    backend: a hot key makes the MR backend's sort + expansion scale with
    the dense product anyway, at which point the sort is pure overhead.
    Defaults keep catalogs from before the skew fields loading (skew 1 =
    uniform = never prefer the matrix backend on stale data)."""

    count: int
    n_subjects: int
    n_objects: int
    max_s_degree: int = 1
    max_o_degree: int = 1

    @property
    def avg_s_degree(self) -> float:
        return self.count / max(1, self.n_subjects)

    @property
    def avg_o_degree(self) -> float:
        return self.count / max(1, self.n_objects)

    @property
    def s_skew(self) -> float:
        return self.max_s_degree / max(1.0, self.avg_s_degree)

    @property
    def o_skew(self) -> float:
        return self.max_o_degree / max(1.0, self.avg_o_degree)


@dataclasses.dataclass(frozen=True)
class StoreStatistics:
    """The statistics catalog the cost-based optimizer plans against.

    Computed once at load time (host numpy over the encoded triples):
    global triple/subject/object counts plus, per predicate id, the triple
    count and the distinct subject/object counts. These drive two
    estimators: `pattern_cardinality` (formula-based match-count estimate
    for a triple pattern without scanning) and `distinct_values` (estimated
    number of distinct bindings a variable takes among a pattern's matches
    — the denominator of the System-R style join selectivity
    |L ⋈ R| ≈ |L|·|R| / max(d_L(v), d_R(v)) the optimizer uses).
    """

    n_triples: int
    n_subjects: int
    n_objects: int
    n_predicates: int
    predicates: dict[int, PredicateStats]

    @classmethod
    def from_triples(cls, triples: np.ndarray) -> "StoreStatistics":
        t = np.asarray(triples, np.int32).reshape(-1, 3)
        n = len(t)
        if n == 0:
            return cls(0, 0, 0, 0, {})
        preds: dict[int, PredicateStats] = {}
        order = np.argsort(t[:, 1], kind="stable")
        ts = t[order]
        pids, starts = np.unique(ts[:, 1], return_index=True)
        bounds = list(starts) + [n]
        for k, pid in enumerate(pids):
            seg = ts[bounds[k]:bounds[k + 1]]
            s_deg = np.unique(seg[:, 0], return_counts=True)[1]
            o_deg = np.unique(seg[:, 2], return_counts=True)[1]
            preds[int(pid)] = PredicateStats(
                count=len(seg),
                n_subjects=int(s_deg.size),
                n_objects=int(o_deg.size),
                max_s_degree=int(s_deg.max()),
                max_o_degree=int(o_deg.max()),
            )
        return cls(
            n_triples=n,
            n_subjects=int(np.unique(t[:, 0]).size),
            n_objects=int(np.unique(t[:, 2]).size),
            n_predicates=len(pids),
            predicates=preds,
        )

    @classmethod
    def merge(cls, parts: "list[StoreStatistics]") -> "StoreStatistics":
        """Aggregate per-shard catalogs into one store-wide catalog.

        Exact for subject-hash partitioned shards on every additive count
        (triple counts sum; subject sets are disjoint across shards, so
        distinct-subject counts sum too). Distinct OBJECT counts can
        overlap between shards, so the merge takes the per-shard maximum —
        a lower bound, which only makes the optimizer's System-R join
        selectivities more conservative (never unsound).
        """
        preds: dict[int, PredicateStats] = {}
        for part in parts:
            for pid, ps in part.predicates.items():
                old = preds.get(pid)
                if old is None:
                    preds[pid] = ps
                else:
                    preds[pid] = PredicateStats(
                        count=old.count + ps.count,
                        n_subjects=old.n_subjects + ps.n_subjects,
                        n_objects=max(old.n_objects, ps.n_objects),
                        # subject degrees are exact under subject-hash
                        # partitioning (a subject lives on one shard);
                        # object degrees merge as a lower bound, like the
                        # distinct-object counts above
                        max_s_degree=max(old.max_s_degree, ps.max_s_degree),
                        max_o_degree=max(old.max_o_degree, ps.max_o_degree),
                    )
        return cls(
            n_triples=sum(p.n_triples for p in parts),
            n_subjects=sum(p.n_subjects for p in parts),
            n_objects=max((p.n_objects for p in parts), default=0),
            n_predicates=len(preds),
            predicates=preds,
        )

    def _bound_ids(self, tp: TriplePattern, lookup) -> dict[str, int] | None:
        """Term ids of the pattern's constants; None if any is unknown
        (an unknown constant can never match — cardinality 0)."""
        out: dict[str, int] = {}
        for pos, term in zip("spo", (tp.s, tp.p, tp.o)):
            if not term.startswith("?"):
                tid = lookup(term)
                if tid is None:
                    return None
                out[pos] = tid
        return out

    def pattern_cardinality(self, tp: TriplePattern, lookup) -> float:
        """Estimated match count for a triple pattern, by uniformity
        assumptions over the catalog (no scan)."""
        bound = self._bound_ids(tp, lookup)
        if bound is None:
            return 0.0
        if "p" in bound:
            ps = self.predicates.get(bound["p"])
            if ps is None:
                return 0.0
            card = float(ps.count)
            if "s" in bound:
                card /= max(1, ps.n_subjects)
            if "o" in bound:
                card /= max(1, ps.n_objects)
            return card
        card = float(self.n_triples)
        if "s" in bound:
            card /= max(1, self.n_subjects)
        if "o" in bound:
            card /= max(1, self.n_objects)
        return card

    def distinct_values(self, tp: TriplePattern, var: str, lookup) -> float:
        """Estimated distinct bindings of `var` among `tp`'s matches."""
        ps = None
        if not tp.p.startswith("?"):
            pid = lookup(tp.p)
            if pid is None:
                return 0.0
            ps = self.predicates.get(pid)
            if ps is None:
                return 0.0
        if var == tp.s:
            return float(ps.n_subjects if ps else self.n_subjects)
        if var == tp.p:
            return float(self.n_predicates)
        if var == tp.o:
            return float(ps.n_objects if ps else self.n_objects)
        return 1.0

    # -- persistence (warmup files carry the catalog so backend decisions
    # -- survive restarts) ------------------------------------------------
    def to_jsonable(self) -> dict:
        return {
            "n_triples": self.n_triples,
            "n_subjects": self.n_subjects,
            "n_objects": self.n_objects,
            "n_predicates": self.n_predicates,
            "predicates": {
                str(pid): [
                    ps.count,
                    ps.n_subjects,
                    ps.n_objects,
                    ps.max_s_degree,
                    ps.max_o_degree,
                ]
                for pid, ps in self.predicates.items()
            },
        }

    @classmethod
    def from_jsonable(cls, obj: dict) -> "StoreStatistics":
        preds: dict[int, PredicateStats] = {}
        for pid, row in obj["predicates"].items():
            # rows from before the skew fields have 3 entries: default the
            # degrees to 1 (uniform — the conservative backend choice)
            count, n_s, n_o = (int(v) for v in row[:3])
            max_s = int(row[3]) if len(row) > 3 else 1
            max_o = int(row[4]) if len(row) > 4 else 1
            preds[int(pid)] = PredicateStats(count, n_s, n_o, max_s, max_o)
        return cls(
            n_triples=int(obj["n_triples"]),
            n_subjects=int(obj["n_subjects"]),
            n_objects=int(obj["n_objects"]),
            n_predicates=int(obj["n_predicates"]),
            predicates=preds,
        )


class PredicateSparse(NamedTuple):
    """A predicate's triples as a device-resident sparse matrix.

    `coo` is the upload-once (subject, object) partial-match block in scan
    order — the SAME device buffers `match_pattern_device` hands the
    executor for a `(?s <p> ?o)` pattern, so caching it here adds no
    staging. The CSR view rides alongside: `order` permutes the COO rows
    into subject-sorted order, `subj_ids` are the distinct subjects and
    `row_ptr` their segment bounds in that order — the adjacency structure
    the masked-SpMM backend's reductions are defined over.
    """

    coo: Relation  # schema ("?0", "?1"), bucketed capacity, valid mask
    subj_ids: torch.Tensor  # (n_subj,) sorted distinct subject ids
    row_ptr: torch.Tensor  # (n_subj + 1,) CSR indptr into sorted order
    order: torch.Tensor  # (nnz,) COO row -> subject-sorted position


@dataclasses.dataclass
class TripleStore:
    triples: np.ndarray  # (n, 3) int32 dictionary-encoded
    dictionary: TermDict
    scan_cache_entries: int = 512  # per cache; FIFO eviction
    # stacked entries are up to batch-width times a solo entry's bytes, so
    # they get a much smaller budget: the steady state this cache serves
    # (the same warm micro-batch repeating) needs few distinct keys
    stacked_cache_entries: int = 32

    def __post_init__(self):
        self.triples = np.asarray(self.triples, np.int32).reshape(-1, 3)
        # delta-block state: the sorted indexes cover the immutable base;
        # inserted rows ride in the tail, deleted base rows in the
        # tombstone set, until compact() folds both into a new base.
        # `triples` stays the *effective* row set (base minus tombstones
        # plus tail), recomputed at each committed write batch — the
        # statistics rebuilds and the differential oracle read it.
        self._base: np.ndarray = self.triples
        self._tail: list[tuple[int, int, int]] = []
        self._tomb: set[int] = set()  # packed (s, p, o) keys, see _pack1
        self._tomb_arr: np.ndarray | None = None  # sorted-key view cache
        self.version = 0  # bumped by every committed write batch/compaction
        self.compactions = 0
        # writers and scan staging share this reentrant lock: a query's
        # scans are staged under it, so every run sees one store version
        self._lock = threading.RLock()
        self._build_indexes()
        # scan caches, keyed by the pattern's canonical structure; entries
        # are (version, value) pairs — a stale entry is evicted (and
        # counted) on its first lookup after a write
        self._rows_cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._device_cache: OrderedDict[tuple, tuple] = OrderedDict()
        # stacked (width, cap, n_cols) gathers for run_batch, keyed by
        # (device, cap, lane keys) — versioned like the scan caches
        self._stacked_cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._stacked_hits = 0
        self._stacked_misses = 0
        self._scan_hits = 0
        self._scan_misses = 0
        self._evictions = 0
        # per-scan-key capacity high-water marks: staged blocks never
        # shrink, so warm plan shapes survive deletes and compaction
        self._cap_floor: dict[tuple, int] = {}
        # device numeric-value tables (FILTER support), per device, each
        # with the dictionary size it was built at
        self._num_vals: dict[str, tuple[int, torch.Tensor]] = {}
        # per-predicate device CSR/COO (matrix join backend), FIFO like the
        # scan caches; shares its COO buffers with _device_cache entries
        self._sparse_cache: OrderedDict[int, tuple] = OrderedDict()
        self._statistics: StoreStatistics | None = None

    @classmethod
    def from_arrays(cls, triples: np.ndarray, terms: list[str]) -> "TripleStore":
        """A store over already-encoded (n, 3) int32 triples whose ids index
        `terms` (id i is terms[i]) — the same data another store of this
        design holds, without re-encoding it."""
        d = TermDict()
        for tid, term in enumerate(terms):
            if d.encode(term) != tid:
                raise ValueError(f"duplicate term {term!r} in the term list")
        return cls(np.asarray(triples, np.int32), d)

    def _build_indexes(self) -> None:
        self._sorted: dict[str, np.ndarray] = {}
        for name, perm in _INDEXES.items():
            reordered = self._base[:, perm]
            order = np.lexsort((reordered[:, 2], reordered[:, 1], reordered[:, 0]))
            self._sorted[name] = np.ascontiguousarray(reordered[order])

    @property
    def statistics(self) -> StoreStatistics:
        """The statistics catalog the cost-based optimizer plans against.

        Computed from the effective triples on first use, then maintained
        incrementally by inserts/deletes (see _stats_note_insert /
        _stats_note_delete) and fully recomputed after a compaction."""
        if self._statistics is None:
            self._statistics = StoreStatistics.from_triples(self.triples)
        return self._statistics

    def __len__(self) -> int:
        return len(self.triples)

    # -- write path (delta blocks, tombstones, compaction) ----------------

    _PACK_BITS = 21  # term ids per tombstone key: 3 x 21 bits in an int64

    def _pack1(self, s: int, p: int, o: int) -> int:
        if max(s, p, o) >= 1 << self._PACK_BITS:
            raise ValueError(
                "tombstone keys pack term ids into 21 bits each; stores "
                "beyond 2M terms need a wider packing"
            )
        b = self._PACK_BITS
        return (s << (2 * b)) | (p << b) | o

    def _pack_rows(self, rows: np.ndarray) -> np.ndarray:
        r = rows.astype(np.int64)
        b = self._PACK_BITS
        return (r[:, 0] << (2 * b)) | (r[:, 1] << b) | r[:, 2]

    def _tomb_mask(self, rows: np.ndarray) -> np.ndarray:
        """True where a base row is tombstoned."""
        if not self._tomb or not len(rows):
            return np.zeros(len(rows), bool)
        if self._tomb_arr is None:
            self._tomb_arr = np.fromiter(
                self._tomb, np.int64, len(self._tomb)
            )
        return np.isin(self._pack_rows(rows), self._tomb_arr)

    def snapshot_lock(self) -> threading.RLock:
        """Reentrant lock shared by writers and scan staging. The engine
        stages a query's scans under it, so every run sees one consistent
        store version even with concurrent updates."""
        return self._lock

    def insert_triples(self, triples) -> int:
        """Encode and insert (s, p, o) term-string triples; returns the
        number actually added (set semantics: duplicates are skipped)."""
        rows = np.array(
            [
                [
                    self.dictionary.encode(s),
                    self.dictionary.encode(p),
                    self.dictionary.encode(o),
                ]
                for s, p, o in triples
            ],
            np.int32,
        ).reshape(-1, 3)
        return self.insert_rows(rows)

    def delete_triples(self, triples) -> int:
        """Delete (s, p, o) term-string triples; returns the number
        removed. Unknown terms mean the triple is absent — skipped without
        growing the dictionary."""
        rows = []
        for s, p, o in triples:
            ids = [self.dictionary.lookup(t) for t in (s, p, o)]
            if None not in ids:
                rows.append(ids)
        return self.delete_rows(np.asarray(rows, np.int32).reshape(-1, 3))

    def insert_rows(self, rows: np.ndarray) -> int:
        """Insert dictionary-encoded rows into the delta tail (or revive a
        tombstoned base row). RDF set semantics: rows already present are
        skipped. Returns the number added."""
        rows = np.asarray(rows, np.int32).reshape(-1, 3)
        n_added = 0
        with self._lock:
            for r in rows:
                s, p, o = (int(x) for x in r)
                if self._count_ids(s, p, o):
                    continue  # already present
                self._stats_note_insert(s, p, o)
                key = self._pack1(s, p, o)
                if key in self._tomb:
                    # re-inserting a deleted base row: just un-tombstone it
                    self._tomb.discard(key)
                    self._tomb_arr = None
                else:
                    self._tail.append((s, p, o))
                n_added += 1
            if n_added:
                self._commit_write()
        return n_added

    def delete_rows(self, rows: np.ndarray) -> int:
        """Delete dictionary-encoded rows: tail rows drop immediately, base
        rows are tombstoned until the next compaction. Returns the number
        removed (absent rows are skipped)."""
        rows = np.asarray(rows, np.int32).reshape(-1, 3)
        n_deleted = 0
        with self._lock:
            for r in rows:
                s, p, o = (int(x) for x in r)
                if not self._count_ids(s, p, o):
                    continue  # absent (or already deleted)
                t = (s, p, o)
                if t in self._tail:
                    self._tail.remove(t)
                else:
                    self._tomb.add(self._pack1(s, p, o))
                    self._tomb_arr = None
                self._stats_note_delete(s, p, o)
                n_deleted += 1
            if n_deleted:
                self._commit_write()
        return n_deleted

    def compact(self) -> None:
        """Fold the tail into a fresh base block: drop tombstoned rows,
        rebuild the three sorted indexes, clear the delta state and the
        scan caches (side tables regrow lazily on next use). Statistics
        are fully recomputed on next access, replacing the incremental
        estimates with exact values. Capacity floors are KEPT, so warm
        plan shapes re-run with zero compiles after a compaction."""
        with self._lock:
            self._base = np.ascontiguousarray(self._effective_triples())
            self._tail = []
            self._tomb = set()
            self._tomb_arr = None
            self._build_indexes()
            self.triples = self._base
            self._statistics = None  # full recompute on next use
            self._drop_scan_caches()
            self._num_vals.clear()  # regrow the numeric side tables
            self.version += 1
            self.compactions += 1

    def write_stats(self) -> dict:
        """Write-path health counters (engine.stats() / server stats())."""
        return {
            "version": self.version,
            "base_rows": int(len(self._base)),
            "tail_rows": len(self._tail),
            "tombstones": len(self._tomb),
            "compactions": self.compactions,
            "total_rows": int(len(self.triples)),
        }

    def _effective_triples(self) -> np.ndarray:
        base = self._base
        if self._tomb:
            base = base[~self._tomb_mask(base)]
        if self._tail:
            return np.concatenate(
                [base, np.asarray(self._tail, np.int32).reshape(-1, 3)]
            )
        return base

    def _commit_write(self) -> None:
        self._tomb_arr = None
        self.version += 1
        self.triples = self._effective_triples()

    def _drop_scan_caches(self) -> None:
        self._evictions += (
            len(self._rows_cache)
            + len(self._device_cache)
            + len(self._sparse_cache)
            + len(self._stacked_cache)
        )
        self._rows_cache.clear()
        self._device_cache.clear()
        self._sparse_cache.clear()
        self._stacked_cache.clear()

    def _count_ids(self, s=None, p=None, o=None) -> int:
        """Effective match count for id-level bound positions (None =
        wildcard) — the membership/degree probe behind set semantics and
        the incremental statistics."""
        bound = {k: v for k, v in zip("spo", (s, p, o)) if v is not None}
        return len(self._effective_for_bound(bound))

    def _stats_note_insert(self, s: int, p: int, o: int) -> None:
        """Incremental catalog maintenance; call BEFORE adding the row.

        Counts and distinct counts stay exact (membership is checked with
        O(log n) range scans); max degrees stay exact on insert."""
        st = self._statistics
        if st is None:
            return  # catalog not materialized yet: built lazily, post-write
        s_deg = self._count_ids(s=s, p=p)
        o_deg = self._count_ids(p=p, o=o)
        new_subj = self._count_ids(s=s) == 0
        new_obj = self._count_ids(o=o) == 0
        ps = st.predicates.get(p)
        if ps is None:
            st.predicates[p] = PredicateStats(1, 1, 1, 1, 1)
        else:
            st.predicates[p] = PredicateStats(
                count=ps.count + 1,
                n_subjects=ps.n_subjects + int(s_deg == 0),
                n_objects=ps.n_objects + int(o_deg == 0),
                max_s_degree=max(ps.max_s_degree, s_deg + 1),
                max_o_degree=max(ps.max_o_degree, o_deg + 1),
            )
        self._statistics = dataclasses.replace(
            st,
            n_triples=st.n_triples + 1,
            n_subjects=st.n_subjects + int(new_subj),
            n_objects=st.n_objects + int(new_obj),
            n_predicates=len(st.predicates),
        )

    def _stats_note_delete(self, s: int, p: int, o: int) -> None:
        """Incremental catalog maintenance; call AFTER removing the row.

        Counts and distinct counts stay exact; max degrees become upper
        bounds (still safe: overestimating skew only biases the optimizer
        toward the matrix backend) until compaction recomputes them."""
        st = self._statistics
        if st is None:
            return
        s_deg = self._count_ids(s=s, p=p)  # remaining degree
        o_deg = self._count_ids(p=p, o=o)
        gone_subj = self._count_ids(s=s) == 0
        gone_obj = self._count_ids(o=o) == 0
        ps = st.predicates.get(p)
        if ps is not None:
            if ps.count <= 1:
                del st.predicates[p]
            else:
                st.predicates[p] = PredicateStats(
                    count=ps.count - 1,
                    n_subjects=max(0, ps.n_subjects - int(s_deg == 0)),
                    n_objects=max(0, ps.n_objects - int(o_deg == 0)),
                    max_s_degree=ps.max_s_degree,
                    max_o_degree=ps.max_o_degree,
                )
        self._statistics = dataclasses.replace(
            st,
            n_triples=max(0, st.n_triples - 1),
            n_subjects=max(0, st.n_subjects - int(gone_subj)),
            n_objects=max(0, st.n_objects - int(gone_obj)),
            n_predicates=len(st.predicates),
        )

    # -- pattern matching ------------------------------------------------
    def _bound(self, tp: TriplePattern) -> dict[str, int]:
        out = {}
        for pos, term in zip("spo", (tp.s, tp.p, tp.o)):
            if not term.startswith("?"):
                tid = self.dictionary.lookup(term)
                out[pos] = -1 if tid is None else tid
        return out

    def _range_scan(self, index: str, prefix_vals: list[int]) -> np.ndarray:
        data = self._sorted[index]
        lo, hi = 0, len(data)
        for level, v in enumerate(prefix_vals):
            col = data[lo:hi, level]
            lo, hi = lo + np.searchsorted(col, v, "left"), lo + np.searchsorted(
                col, v, "right"
            )
        return data[lo:hi]

    def _scan_key(self, tp: TriplePattern) -> tuple:
        """Canonical pattern structure: variables -> ?0/?1/... by first
        appearance (captures repeated-variable filters), constants verbatim.
        """
        seen: dict[str, str] = {}
        out = []
        for term in (tp.s, tp.p, tp.o):
            if term.startswith("?"):
                if term not in seen:
                    seen[term] = f"?{len(seen)}"
                out.append(seen[term])
            else:
                out.append(term)
        return tuple(out)

    @staticmethod
    def _put(cache: OrderedDict, key, value, limit: int) -> None:
        cache[key] = value
        while len(cache) > limit:
            cache.popitem(last=False)

    def _vget(self, cache: OrderedDict, key):
        """Version-checked cache lookup: a hit staged at an older store
        version is evicted (and counted) instead of being served stale —
        and instead of piling up beside its replacement, which is what
        kept these caches bounded across writes."""
        slot = cache.get(key)
        if slot is None:
            return None
        ver, value = slot
        if ver == self.version:
            return value
        del cache[key]
        self._evictions += 1
        return None

    def estimate_cardinality(self, tp: TriplePattern) -> int:
        return len(self.match_rows(tp))

    def match_rows(self, tp: TriplePattern) -> np.ndarray:
        """Matching *effective* triples (base minus tombstones plus tail)
        in (s, p, o) column order (cached; treat the returned array as
        read-only)."""
        key = self._scan_key(tp)
        cached = self._vget(self._rows_cache, key)
        if cached is not None:
            return cached
        rows = self._match_rows_uncached(tp)
        self._put(
            self._rows_cache, key, (self.version, rows), self.scan_cache_entries
        )
        return rows

    def _match_rows_uncached(self, tp: TriplePattern) -> np.ndarray:
        bound = self._bound(tp)
        if any(v < 0 for v in bound.values()):
            return np.zeros((0, 3), np.int32)  # unknown constant: no matches
        return self._effective_for_bound(bound)

    def _rows_for_bound(self, bound: dict[str, int]) -> np.ndarray:
        """Base-block rows matching the bound positions, in scan order.
        Tombstoned rows are NOT filtered here — staged scans retain them
        (masked invalid) so block shapes stay stable across deletes."""
        key = tuple(sorted(bound.keys(), key="spo".index))
        index = _CHOICE[key]  # every bound-position subset has an index
        perm = _INDEXES[index]
        pos_order = ["spo"[i] for i in perm]
        prefix = []
        for p in pos_order:
            if p in bound:
                prefix.append(bound[p])
            else:
                break
        rows = self._range_scan(index, prefix)
        # invert the permutation back to (s, p, o)
        inv = np.argsort(perm)
        rows = rows[:, inv]
        # residual filters for bound positions beyond the sorted prefix
        for i, p in enumerate("spo"):
            if p in bound and p not in pos_order[: len(prefix)]:
                rows = rows[rows[:, i] == bound[p]]
        return rows

    def _tail_rows_for_bound(self, bound: dict[str, int]) -> np.ndarray:
        """Tail (inserted) rows matching the bound positions. The tail is
        small by construction — compaction folds it away — so a linear
        pass is fine."""
        if not self._tail:
            return np.zeros((0, 3), np.int32)
        idx = {"s": 0, "p": 1, "o": 2}
        out = [
            t
            for t in self._tail
            if all(t[idx[k]] == v for k, v in bound.items())
        ]
        return np.asarray(out, np.int32).reshape(-1, 3)

    def _effective_for_bound(self, bound: dict[str, int]) -> np.ndarray:
        base = self._rows_for_bound(bound)
        if self._tomb:
            base = base[~self._tomb_mask(base)]
        tail = self._tail_rows_for_bound(bound)
        if len(tail):
            return np.concatenate([base, tail])
        return base

    def _pattern_columns(
        self, tp: TriplePattern, rows: np.ndarray
    ) -> tuple[tuple[str, ...], np.ndarray]:
        """Project matched triples to the pattern's variable columns,
        filtering repeated variables (e.g. (?x p ?x))."""
        vars_: list[str] = []
        cols: list[int] = []
        for i, term in enumerate((tp.s, tp.p, tp.o)):
            if term.startswith("?"):
                if term in vars_:  # repeated var: equality filter
                    rows = rows[rows[:, i] == rows[:, cols[vars_.index(term)]]]
                else:
                    vars_.append(term)
                    cols.append(i)
        mat = rows[:, cols] if len(rows) else np.zeros((0, len(cols)), np.int32)
        return tuple(vars_), mat

    def _staged_columns(
        self, tp: TriplePattern
    ) -> tuple[tuple[str, ...], np.ndarray, np.ndarray]:
        """The pattern's staged partial-match block: (vars, columns, valid).

        Base matches come first in scan order with tombstoned rows RETAINED
        but masked invalid — the compiled program's validity masks apply
        the delete device-side, so a delete never changes block shapes —
        then the tail (inserted) matches follow. Repeated-variable
        equality (e.g. `?x p ?x`) drops rows outright; that is a per-row
        property, stable across versions, so capacities stay deterministic.
        """
        bound = self._bound(tp)
        vars_: list[str] = []
        cols: list[int] = []
        seen: dict[str, int] = {}
        for i, term in enumerate((tp.s, tp.p, tp.o)):
            if term.startswith("?") and term not in seen:
                seen[term] = i
                vars_.append(term)
                cols.append(i)
        if any(v < 0 for v in bound.values()):
            return (
                tuple(vars_),
                np.zeros((0, len(cols)), np.int32),
                np.zeros((0,), bool),
            )
        base = self._rows_for_bound(bound)
        live = ~self._tomb_mask(base)
        tail = self._tail_rows_for_bound(bound)
        if len(tail):
            rows = np.concatenate([base, tail])
            valid = np.concatenate([live, np.ones(len(tail), bool)])
        else:
            rows, valid = base, live
        keep = np.ones(len(rows), bool)
        for i, term in enumerate((tp.s, tp.p, tp.o)):
            if term.startswith("?") and seen.get(term) != i:
                keep &= rows[:, i] == rows[:, seen[term]]
        if not keep.all():
            rows, valid = rows[keep], valid[keep]
        mat = rows[:, cols] if len(rows) else np.zeros((0, len(cols)), np.int32)
        return tuple(vars_), mat, valid

    def _device_capacity(self, key: tuple, staged: int) -> int:
        """Bucketed capacity for a staged block, floored by the pattern's
        high-water mark: capacities never shrink, so warm plan shapes (and
        their compiled executables) survive deletes and compaction."""
        cap = max(bucket_capacity(staged), self._cap_floor.get(key, 0))
        self._cap_floor[key] = cap
        return cap

    def scan_capacity(self, tp: TriplePattern) -> int:
        """The capacity `match_pattern_device` would stage this pattern at
        right now, without uploading anything (explain's cache probe)."""
        key = self._scan_key(tp)
        _, mat, _ = self._staged_columns(tp)
        return max(bucket_capacity(len(mat)), self._cap_floor.get(key, 0))

    @staticmethod
    def _staged_relation(
        schema: tuple, mat: np.ndarray, valid: np.ndarray, capacity: int,
        device,
    ) -> Relation:
        """Upload a staged block at `capacity`, carrying a per-row validity
        mask (Relation.from_numpy marks every staged row valid, which can't
        express tombstones)."""
        cols = np.zeros((capacity, mat.shape[1]), np.int32)
        cols[: len(mat)] = mat
        v = np.zeros((capacity,), bool)
        v[: len(valid)] = valid
        return Relation(
            tuple(schema),
            torch.from_numpy(cols).to(device),
            torch.from_numpy(v).to(device),
        )

    def match_pattern(
        self, tp: TriplePattern, device, min_capacity: int = 1
    ) -> Relation:
        """Partial-match Relation over the pattern's variables (eager path:
        fresh host->device upload, exact next-pow2 capacity)."""
        vars_, mat = self._pattern_columns(tp, self.match_rows(tp))
        capacity = max(min_capacity, next_pow2(len(mat)))
        return Relation.from_numpy(vars_, mat, capacity=capacity, device=device)

    def match_pattern_device(self, tp: TriplePattern, device) -> Relation:
        """Device-resident staged partial match at a bucketed capacity.

        The device arrays are uploaded once per pattern structure, store
        version and device, and shared by every subsequent call (and across queries
        differing only in variable spelling); the returned Relation just
        rebinds the schema to this pattern's variable names. A `(?s <p> ?o)`
        pattern shares its buffers with the predicate's sparse
        representation (`predicate_sparse`) instead of uploading a second
        copy.
        """
        key = self._scan_key(tp)
        dev = str(torch.device(device))
        entry = self._vget(self._device_cache, (dev, key))
        if entry is None:
            self._scan_misses += 1
            if key[0] == "?0" and key[2] == "?1" and not key[1].startswith("?"):
                # (?s <p> ?o) with distinct vars: reuse the predicate COO
                sp = self.predicate_sparse(tp.p, device)
                entry = sp.coo if sp is not None else self._staged_relation(
                    ("?0", "?1"),
                    np.zeros((0, 2), np.int32),
                    np.zeros((0,), bool),
                    self._device_capacity(key, 0),
                    device,
                )
            else:
                vars_, mat, valid = self._staged_columns(tp)
                placeholder = tuple(f"?{i}" for i in range(len(vars_)))
                entry = self._staged_relation(
                    placeholder, mat, valid,
                    self._device_capacity(key, len(mat)), device,
                )
            self._put(
                self._device_cache,
                (dev, key),
                (self.version, entry),
                self.scan_cache_entries,
            )
        else:
            self._scan_hits += 1
        actual, _ = self._pattern_columns(tp, np.zeros((0, 3), np.int32))
        return Relation(tuple(actual), entry.cols, entry.valid)

    def predicate_sparse(self, pred: str, device) -> "PredicateSparse | None":
        """The predicate's device CSR/COO bundle (None for an unknown
        predicate term), built on first use and cached FIFO. The COO block
        is in scan order — identical rows, order and capacity to the
        `match_pattern_device` entry for `(?s <p> ?o)` — so both caches
        point at one device allocation."""
        pid = self.dictionary.lookup(pred)
        if pid is None:
            return None
        dev = str(torch.device(device))
        entry = self._vget(self._sparse_cache, (dev, pid))
        if entry is not None:
            return entry
        tp = TriplePattern("?s", pred, "?o")
        _, mat, valid = self._staged_columns(tp)
        coo = self._staged_relation(
            ("?0", "?1"),
            mat,
            valid,
            self._device_capacity(("?0", pred, "?1"), len(mat)),
            device,
        )
        # CSR over the staged rows (tombstoned rows included: the masked
        # reductions see their validity through the COO mask)
        order = np.argsort(mat[:, 0], kind="stable").astype(np.int32)
        subj_ids, seg_counts = np.unique(mat[:, 0], return_counts=True)
        row_ptr = np.zeros(len(subj_ids) + 1, np.int32)
        np.cumsum(seg_counts, out=row_ptr[1:])
        entry = PredicateSparse(
            coo=coo,
            subj_ids=torch.from_numpy(subj_ids.astype(np.int32)).to(device),
            row_ptr=torch.from_numpy(row_ptr).to(device),
            order=torch.from_numpy(order).to(device),
        )
        self._put(
            self._sparse_cache, (dev, pid), (self.version, entry),
            self.scan_cache_entries,
        )
        return entry

    def stacked_scan_device(
        self, tps: "tuple[TriplePattern, ...]", device, cap: "int | None" = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One scan position of a stacked batch: the partial matches of
        `tps` (one pattern per lane, trailing padding lanes repeating
        lane 0) gathered into (width, capacity, n_cols) cols and
        (width, capacity) valid device tensors.

        Within a same-shape plan group every lane stages at one capacity
        bucket by construction (capacity is part of the PlanShape queries
        group on). A cross-shape PADDED group passes `cap` — the group's
        per-position max bucket — and each lane is padded up to it with
        valid=False rows before stacking. The gather is cached by the
        (device, capacity, lane keys) tuple, so a warm repeated batch (the
        serving steady state) re-dispatches the same stacked buffers
        without re-staging anything.
        """
        dev = str(torch.device(device))
        key = (dev, "stacked", cap) + tuple(self._scan_key(tp) for tp in tps)
        entry = self._vget(self._stacked_cache, key)
        if entry is None:
            self._stacked_misses += 1
            rels = [self.match_pattern_device(tp, device) for tp in tps]
            if cap is not None:
                rels = [pad_to(r, cap) for r in rels]
            entry = (
                torch.stack([r.cols for r in rels]),
                torch.stack([r.valid for r in rels]),
            )
            self._put(
                self._stacked_cache,
                key,
                (self.version, entry),
                self.stacked_cache_entries,
            )
        else:
            self._stacked_hits += 1
        return entry

    def pattern_scan_info(self, tp: TriplePattern) -> tuple[tuple[str, ...], int]:
        """Host-side (schema, effective matching-row count) for a pattern —
        what a device scan would bind, without uploading anything. Shown by
        PreparedQuery.explain(); the cache probe uses scan_capacity()."""
        vars_, mat = self._pattern_columns(tp, self.match_rows(tp))
        return vars_, len(mat)

    def numeric_values_device(self, device) -> torch.Tensor:
        """Per-term-id numeric value table, padded to the next pow-2 of the
        dictionary size and rebuilt when inserts grow the dictionary.

        Gathered by term id inside compiled FILTER masks so numeric
        literals compare by value. The pow-2 padding keeps the table's
        device shape stable while the dictionary grows within a bucket;
        crossing a bucket boundary recompiles affected plans (the engine
        checks the table shape against each plan-cache entry)."""
        n = len(self.dictionary)
        dev = str(torch.device(device))
        built = self._num_vals.get(dev)
        if built is None or built[0] != n:
            vals = np.asarray(self.dictionary.numeric_values(), np.float32)
            cap = next_pow2(max(1, n))
            if cap > len(vals):
                pad = np.full(cap - len(vals), np.nan, np.float32)
                vals = np.concatenate([vals, pad])
            built = (n, torch.from_numpy(vals).to(device))
            self._num_vals[dev] = built
        return built[1]

    def scan_cache_stats(self) -> dict:
        return {
            "hits": self._scan_hits,
            "misses": self._scan_misses,
            "entries": len(self._device_cache),
            "evictions": self._evictions,
            "stacked_hits": self._stacked_hits,
            "stacked_misses": self._stacked_misses,
            "stacked_entries": len(self._stacked_cache),
        }


def store_from_string_triples(
    triples: list[tuple[str, str, str]], dictionary: TermDict | None = None
) -> TripleStore:
    d = dictionary or TermDict()
    enc = np.array(
        [[d.encode(s), d.encode(p), d.encode(o)] for s, p, o in triples], np.int32
    ).reshape(-1, 3)
    return TripleStore(enc, d)

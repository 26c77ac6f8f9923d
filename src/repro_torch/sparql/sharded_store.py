"""Subject-hash sharded triple store: the storage half of distributed MapSQ.

gStoreD (the paper's distributed baseline) partitions the RDF graph across
workers and plans partition-aware joins; this module is our equivalent.
The triple set is hash-partitioned by SUBJECT id — the same FNV-1a hash
the shuffle exchanges route by (core/distributed.hash_keys), mirrored here
on host numpy — into `n_shards` disjoint partitions, each with its own
sorted SPO/POS/OSP indexes (a plain TripleStore over the partition,
sharing one global TermDict, so dictionary ids are store-wide).

Scans stay partitioned end to end: `match_pattern_device` range-scans
every shard, pads each shard's matches to ONE shared pow-2 capacity
bucket (the max across shards — the sharded program needs equal static
shapes per shard) and uploads a flat (n_shards * cap, n_cols) device
buffer whose row blocks are the per-shard partitions, in shard order. The
sharded executor views it as (n_shards, cap, n_cols): every shard lives on
the one device, along an explicit leading shard axis. With one shard per
process (core/ranks.py) every rank keeps every shard's host store, so
the bucket, the statistics and the write routing agree on every rank
with no communication, and uploads only its own `shard`'s block at that
bucket. Scan data is uploaded once per pattern structure and never
re-staged (the same upload-once discipline as the single-device store,
now per shard).

The `statistics` catalog the cost-based optimizer plans against is the
per-shard catalogs aggregated by `StoreStatistics.merge` — exact on all
additive counts for a subject-hash partitioning (see merge's docstring).

Writes reuse the single-device delta design per shard: inserts are routed
to their owner shard by the same subject hash, deletes tombstone inside
the owning shard, and `compact()` compacts every shard. The flat stacked
scan cache is versioned like the per-shard caches — a write bumps the
store version and stale flat blocks are evicted on their next lookup —
and per-pattern capacity floors keep the shared per-shard bucket from
shrinking, so compiled sharded programs survive updates too.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.plan_ir import bucket_capacity
from repro_torch.core.planner import TriplePattern
from repro_torch.core.relation import Relation
from repro_torch.sparql.dictionary import TermDict
from repro_torch.sparql.store import StoreStatistics, TripleStore

_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)


def subject_shard(subject_ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard per subject id: FNV-1a (the device shuffle's hash,
    core/distributed.hash_keys) mod n_shards, on host numpy."""
    s = np.asarray(subject_ids).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (_FNV_OFFSET ^ s) * _FNV_PRIME
    return (h % np.uint32(n_shards)).astype(np.int64)


@dataclasses.dataclass
class ShardedTripleStore:
    """`n_shards` disjoint subject-hash partitions behind one store API.

    Exposes the same planning/scan surface the QueryEngine consumes
    (dictionary, statistics, estimate_cardinality, pattern_scan_info,
    match_pattern_device, numeric_values_device) — with the sharded
    semantics that `match_pattern_device` returns the flat stacked
    per-shard partitions and `scan_capacity` reports the PER-SHARD
    capacity bucket (the number a compiled sharded program is specialised
    on), so the plan-cache key probing in explain() stays correct.
    """

    triples: np.ndarray  # (n, 3) int32 dictionary-encoded (all shards)
    dictionary: TermDict
    n_shards: int
    scan_cache_entries: int = 512

    def __post_init__(self):
        assert self.n_shards >= 1
        self.triples = np.asarray(self.triples, np.int32).reshape(-1, 3)
        owner = subject_shard(self.triples[:, 0], self.n_shards)
        self.shards: list[TripleStore] = [
            TripleStore(
                self.triples[owner == k],
                self.dictionary,
                scan_cache_entries=self.scan_cache_entries,
            )
            for k in range(self.n_shards)
        ]
        # flat stacked (n_shards * cap) device scans, keyed by (device,
        # pattern structure): one upload per pattern structure, per shard.
        # Entries are (version, value) pairs; stale versions are evicted
        # (and counted) on lookup, mirroring the per-shard caches.
        self._device_cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._scan_hits = 0
        self._scan_misses = 0
        self._evictions = 0
        # shared per-shard capacity floors (see TripleStore._device_capacity)
        self._cap_floor: dict[tuple, int] = {}
        self.version = 0
        self.compactions = 0
        self._lock = threading.RLock()
        self._statistics: StoreStatistics | None = None

    def __len__(self) -> int:
        return len(self.triples)

    @property
    def statistics(self) -> StoreStatistics:
        """Per-shard catalogs aggregated across the shards. Re-merged
        lazily after each write batch (the per-shard catalogs themselves
        are maintained incrementally, so the merge is the only repeated
        work)."""
        if self._statistics is None:
            self._statistics = StoreStatistics.merge(
                [s.statistics for s in self.shards]
            )
        return self._statistics

    # -- write path (routed per-shard deltas) -----------------------------
    def snapshot_lock(self) -> threading.RLock:
        """Store-wide writer/staging lock (see TripleStore.snapshot_lock).
        Writers take this before the per-shard locks, staging takes only
        this — one consistent order, no deadlocks."""
        return self._lock

    def insert_triples(self, triples) -> int:
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
        rows = []
        for s, p, o in triples:
            ids = [self.dictionary.lookup(t) for t in (s, p, o)]
            if None not in ids:
                rows.append(ids)
        return self.delete_rows(np.asarray(rows, np.int32).reshape(-1, 3))

    def insert_rows(self, rows: np.ndarray) -> int:
        """Route encoded rows to their owner shard (same subject hash as
        the device shuffle) and insert into each shard's delta tail.
        Set-semantics dedup stays exact: a triple's duplicates always hash
        to the same shard. Returns the number added."""
        rows = np.asarray(rows, np.int32).reshape(-1, 3)
        n_added = 0
        with self._lock:
            owner = subject_shard(rows[:, 0], self.n_shards)
            for k, shard in enumerate(self.shards):
                part = rows[owner == k]
                if len(part):
                    n_added += shard.insert_rows(part)
            if n_added:
                self._commit_write()
        return n_added

    def delete_rows(self, rows: np.ndarray) -> int:
        rows = np.asarray(rows, np.int32).reshape(-1, 3)
        n_deleted = 0
        with self._lock:
            owner = subject_shard(rows[:, 0], self.n_shards)
            for k, shard in enumerate(self.shards):
                part = rows[owner == k]
                if len(part):
                    n_deleted += shard.delete_rows(part)
            if n_deleted:
                self._commit_write()
        return n_deleted

    def compact(self) -> None:
        """Compact every shard (fold tails, drop tombstones, rebuild the
        per-shard indexes) and invalidate the flat stacked scan cache.
        Capacity floors are kept, so warm sharded plan shapes survive."""
        with self._lock:
            for shard in self.shards:
                shard.compact()
            self._evictions += len(self._device_cache)
            self._device_cache.clear()
            self.version += 1
            self.compactions += 1
            self.triples = np.concatenate([s.triples for s in self.shards])
            self._statistics = None

    def write_stats(self) -> dict:
        parts = [s.write_stats() for s in self.shards]
        return {
            "version": self.version,
            "base_rows": sum(p["base_rows"] for p in parts),
            "tail_rows": sum(p["tail_rows"] for p in parts),
            "tombstones": sum(p["tombstones"] for p in parts),
            "compactions": self.compactions,
            "total_rows": int(len(self.triples)),
            "n_shards": self.n_shards,
        }

    def _commit_write(self) -> None:
        self.version += 1
        self.triples = np.concatenate([s.triples for s in self.shards])
        self._statistics = None  # re-merge the per-shard catalogs lazily

    # -- planning surface -------------------------------------------------
    def estimate_cardinality(self, tp: TriplePattern) -> int:
        """Store-wide match count: the per-shard counts sum exactly
        (partitions are disjoint)."""
        return sum(s.estimate_cardinality(tp) for s in self.shards)

    def pattern_scan_info(
        self, tp: TriplePattern
    ) -> tuple[tuple[str, ...], int]:
        """(schema, max per-shard effective match count) — display data for
        explain(); the plan-cache probe uses scan_capacity()."""
        schema: tuple[str, ...] = ()
        worst = 0
        for s in self.shards:
            schema, n = s.pattern_scan_info(tp)
            worst = max(worst, n)
        return schema, worst

    def scan_capacity(self, tp: TriplePattern) -> int:
        """The shared per-shard bucket `match_pattern_device` would stage
        this pattern at right now (staged rows incl. tombstone-masked base
        rows, floored by the pattern's high-water mark)."""
        key = self._scan_key(tp)
        worst = max(len(s._staged_columns(tp)[1]) for s in self.shards)
        return max(bucket_capacity(worst), self._cap_floor.get(key, 0))

    # -- device scans ------------------------------------------------------
    def per_shard_counts(self, tp: TriplePattern) -> list[int]:
        return [len(s.match_rows(tp)) for s in self.shards]

    def _lookup(self, key: tuple):
        """The cached value under `key` at the current version (a stale
        entry is evicted and counted), or None."""
        slot = self._device_cache.get(key)
        if slot is None:
            return None
        ver, value = slot
        if ver == self.version:
            return value
        del self._device_cache[key]
        self._evictions += 1
        return None

    def _store(self, key: tuple, value) -> None:
        self._device_cache[key] = (self.version, value)
        while len(self._device_cache) > self.scan_cache_entries:
            self._device_cache.popitem(last=False)

    def match_pattern_device(self, tp: TriplePattern, device,
                             shard: "int | None" = None) -> Relation:
        """Flat stacked per-shard partial match at one shared bucket.

        Row block k (`[k * cap, (k + 1) * cap)`) holds shard k's matches,
        padded to cap = bucket_capacity(max per-shard count). With
        `shard`, only that shard's block (cap rows) is uploaded: a rank's
        own partition. Device tensors are uploaded once per pattern
        structure, device and shard and shared across queries (the
        Relation rebinds only the schema names) — the upload-once-per-
        shard contract.
        """
        key = self._scan_key(tp)
        cache_key = (str(torch.device(device)), shard, key)
        entry = self._lookup(cache_key)
        if entry is None:
            self._scan_misses += 1
            per_shard = []
            for s in self.shards:
                _, mat, valid = s._staged_columns(tp)
                per_shard.append((mat, valid))
            cap = max(
                bucket_capacity(max(len(m) for m, _ in per_shard)),
                self._cap_floor.get(key, 0),
            )
            self._cap_floor[key] = cap
            n_cols = per_shard[0][0].shape[1]
            if shard is not None:
                per_shard = [per_shard[shard]]
            cols = np.zeros((len(per_shard) * cap, n_cols), np.int32)
            valid = np.zeros((len(per_shard) * cap,), bool)
            for k, (mat, v) in enumerate(per_shard):
                cols[k * cap : k * cap + len(mat)] = mat
                valid[k * cap : k * cap + len(mat)] = v
            placeholder = tuple(f"?{i}" for i in range(n_cols))
            entry = Relation(
                placeholder,
                torch.from_numpy(cols).to(device),
                torch.from_numpy(valid).to(device),
            )
            self._store(cache_key, entry)
        else:
            self._scan_hits += 1
        actual, _ = self.shards[0]._pattern_columns(
            tp, np.zeros((0, 3), np.int32)
        )
        return Relation(tuple(actual), entry.cols, entry.valid)

    def _scan_key(self, tp: TriplePattern) -> tuple:
        """Canonical pattern structure (see TripleStore._scan_key) — the
        engine's batch grouping compares lanes' scan keys through us."""
        return self.shards[0]._scan_key(tp)

    def stacked_scan_device(
        self, tps: "tuple[TriplePattern, ...]", device,
        shard: "int | None" = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One scan position of a stacked sharded batch: (width,
        n_shards * cap, n_cols) cols and (width, n_shards * cap) valid —
        each lane's flat per-shard blocks stacked on a leading lane axis
        (with `shard`, that shard's block alone: (width, cap, ...)).
        Lanes share one capacity bucket by construction (capacity is part
        of the PlanShape they group on). Cached by the lane-key tuple at
        the current store version, like the flat scans."""
        key = (str(torch.device(device)), shard, "stacked") + tuple(
            self._scan_key(tp) for tp in tps
        )
        entry = self._lookup(key)
        if entry is not None:
            self._scan_hits += 1
            return entry
        self._scan_misses += 1
        rels = [self.match_pattern_device(tp, device, shard) for tp in tps]
        entry = (
            torch.stack([r.cols for r in rels]),
            torch.stack([r.valid for r in rels]),
        )
        self._store(key, entry)
        return entry

    def numeric_values_device(self, device) -> torch.Tensor:
        return self.shards[0].numeric_values_device(device)

    def scan_cache_stats(self) -> dict:
        return {
            "hits": self._scan_hits,
            "misses": self._scan_misses,
            "entries": len(self._device_cache),
            "evictions": self._evictions,
        }

    def shard_sizes(self) -> list[int]:
        return [len(s) for s in self.shards]


def shard_store(store: TripleStore, n_shards: int) -> ShardedTripleStore:
    """Partition an existing single-device store across `n_shards`."""
    return ShardedTripleStore(store.triples, store.dictionary, n_shards)


def sharded_store_from_string_triples(
    triples: list[tuple[str, str, str]],
    n_shards: int,
    dictionary: TermDict | None = None,
) -> ShardedTripleStore:
    d = dictionary or TermDict()
    enc = np.array(
        [[d.encode(s), d.encode(p), d.encode(o)] for s, p, o in triples],
        np.int32,
    ).reshape(-1, 3)
    return ShardedTripleStore(enc, d, n_shards)

"""Term dictionary: RDF terms <-> dense int32 ids.

Dictionary encoding happens on the host (the paper's CPU side); all device
arrays hold ids only. Ids are dense so they double as array indexes — the
property `numeric_values` exploits for device-side FILTER evaluation: the
returned table is gathered by term id to compare numeric literals by value
(so `5` matches `5.0`) instead of by identity — and `decode_ids`, which
turns a result's id matrix into its terms with one gather from an object
array of the terms.
"""
from __future__ import annotations

import re
import threading
from typing import Iterable

import numpy as np

# bare integer/decimal lexical forms; quoted strings and IRIs never match
_NUMERIC = re.compile(r"-?\d+(?:\.\d+)?")


class TermDict:
    def __init__(self):
        self._term_to_id: dict[str, int] = {}
        self._id_to_term: list[str] = []
        # decode_ids' term table: `_table` is the first len(self) slots of
        # `_buf`, which has room to grow. The dictionary only appends, so
        # the table is extended in place past the published view and the
        # longer view published with one assignment; readers keep theirs.
        self._buf = np.empty(0, object)
        self._table = self._buf
        self._table_lock = threading.Lock()

    def encode(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._id_to_term)
            self._term_to_id[term] = tid
            self._id_to_term.append(term)
        return tid

    def encode_many(self, terms: Iterable[str]) -> list[int]:
        return [self.encode(t) for t in terms]

    def lookup(self, term: str) -> int | None:
        return self._term_to_id.get(term)

    def decode(self, tid: int) -> str:
        return self._id_to_term[tid]

    def decode_ids(self, ids: np.ndarray) -> np.ndarray:
        """The terms of an integer array of ids: an object array of the
        same shape, from one gather, with no Python call per id. Every id
        must be one this dictionary gave: mask UNBOUND (-1) first, which
        would index the last term. Safe beside `encode` on another
        thread; the table catches up with the terms encoded since."""
        table = self._table
        if len(table) < len(self._id_to_term):
            table = self._extend_table()
        return table[ids]

    def _extend_table(self) -> np.ndarray:
        with self._table_lock:
            old, n = len(self._table), len(self._id_to_term)
            if n > old:
                if n > len(self._buf):
                    buf = np.empty(n + n // 8, object)
                    buf[:old] = self._buf[:old]
                    self._buf = buf
                self._buf[old:n] = self._id_to_term[old:n]
                self._table = self._buf[:n]
            return self._table

    def numeric_values(self) -> np.ndarray:
        """Per-id numeric value table (NaN for non-numeric terms).

        float32 is the engine's numeric-comparison precision contract:
        integers beyond 2^24 compare by their rounded value (the reference
        oracle in sparql/baseline.py applies the same rounding). Sized at
        least 1 so it stays gatherable for empty dictionaries.
        """
        out = np.full(max(1, len(self._id_to_term)), np.nan, np.float32)
        for i, term in enumerate(self._id_to_term):
            if _NUMERIC.fullmatch(term):
                out[i] = float(term)
        return out

    def __len__(self) -> int:
        return len(self._id_to_term)

    def __contains__(self, term: str) -> bool:
        return term in self._term_to_id

"""Synthetic LM token pipeline (a copy of `repro.data.tokens`, numpy only):
deterministic, step-addressed, checkpointable.

Batches are a pure function of (seed, step), so a restarted job regenerates
the exact stream — the pipeline 'state' in a checkpoint is just the step
counter. Across data ranks each rank takes its rows of the global batch
(`data_rows`), so the ranks together see the one-process stream. A background thread prefetches the next batch (host-side overlap
with device compute).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0  # checkpointable cursor

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        # zipf-ish marginal so losses move like natural text, not uniform
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __next__(self) -> dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.seed, self.step = int(st["seed"]), int(st["step"])


def data_rows(batch: dict, index: int, count: int) -> dict:
    """Data rank `index` of `count`'s rows of a global batch: the
    contiguous block of B / count rows, so the ranks' blocks, stacked in
    rank order, are the one-process batch."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"over {count} data ranks")
        n = v.shape[0] // count
        out[k] = v[index * n:(index + 1) * n]
    return out


class Prefetcher:
    """One-slot lookahead prefetch thread over any pipeline with __next__."""

    def __init__(self, pipeline, depth: int = 2):
        self.pipeline = pipeline
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        while not self._stop.is_set():
            try:
                self.q.put(next(self.pipeline), timeout=0.1)
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=2)

"""Serving-side decode stage: `DecodePool`, the host half of the SPARQL
serving pipeline. The MicroBatcher thread dispatches device work and hands
each request's finalisation (device→host transfer + row materialisation)
to this bounded worker pool, so dispatch of batch k+1 overlaps decode of
batch k (MapSQ's CPU/GPU split applied to the serving tier).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable


class DecodePool:
    """Bounded pool of daemon workers that finalise batch result slots off
    the batcher thread.

    Items are (request, fn) pairs where `request` duck-types the
    batcher's Request (``.result``, ``.event``, ``.abandoned``) and
    ``fn()`` produces the request's final value. Crash isolation is per
    item: any exception a worker hits becomes that one request's result
    (re-raised on the submitter's thread) and the worker keeps serving.
    Should a worker thread die anyway (e.g. a BaseException escaping the
    handler during interpreter teardown), `submit` respawns it, so a
    decode-worker crash never wedges the server. Abandoned requests
    (submitter deadline already expired) are skipped without decoding.
    """

    def __init__(self, n_workers: int = 2, max_queue: int = 64):
        self.n_workers = max(1, n_workers)
        self.q: queue.Queue = queue.Queue(maxsize=max(1, max_queue))
        self._lock = threading.Lock()
        self._closed = False
        self.n_decoded = 0
        self.n_errors = 0   # fn() raised; exception delivered to submitter
        self.n_skipped = 0  # abandoned requests dropped undecoded
        self.max_depth = 0  # high-water queue depth observed at submit
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(self.n_workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, request: Any, fn: Callable[[], Any]) -> None:
        """Enqueue one finalisation. Blocks (backpressure on the batcher
        thread) when the queue is full rather than growing unboundedly."""
        with self._lock:
            if self._closed:
                raise RuntimeError("DecodePool is closed")
            # respawn any worker that died outside the per-item handler
            for i, t in enumerate(self._threads):
                if not t.is_alive():
                    nt = threading.Thread(target=self._worker, daemon=True)
                    self._threads[i] = nt
                    nt.start()
        depth = self.q.qsize() + 1
        if depth > self.max_depth:
            self.max_depth = depth
        self.q.put((request, fn))

    def _worker(self) -> None:
        while True:
            item = self.q.get()
            if item is None:  # close() sentinel
                return
            self._finish(*item)
            # hold nothing of a finished request while waiting for the
            # next: freeing its (possibly large) result belongs to its
            # consumer, not to whichever request this worker takes next
            del item

    def _finish(self, r: Any, fn: Callable[[], Any]) -> None:
        trace = getattr(r, "trace", None)
        if getattr(r, "abandoned", False):
            self.n_skipped += 1
            if trace is not None:
                # retroactive zero-length marker: the skip closes the
                # request's trace path without decoding anything
                t = time.perf_counter()
                trace.add_span("decode_skipped", t, t, abandoned=True)
            r.event.set()
            return
        try:
            r.result = fn()
            self.n_decoded += 1
        except BaseException as e:
            r.result = e
            self.n_errors += 1
            if trace is not None:
                t = time.perf_counter()
                trace.add_span(
                    "decode_error", t, t, error=type(e).__name__
                )
        r.event.set()

    def stats(self) -> dict:
        return {
            "workers": self.n_workers,
            "decoded": self.n_decoded,
            "errors": self.n_errors,
            "skipped": self.n_skipped,
            "max_depth": self.max_depth,
            "depth": self.q.qsize(),
        }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._threads:
            self.q.put(None)
        for t in self._threads:
            t.join(timeout=2)

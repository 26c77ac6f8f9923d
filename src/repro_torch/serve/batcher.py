"""Request micro-batcher: collects requests into fixed-size device batches
(pad-to-capacity, the serving analogue of the Mars static-shape discipline),
dispatches when full or when max_wait elapses.

The batcher thread is the serving tier's CPU stage of the MapSQ
coprocessing split: it must only GROUP and DISPATCH. Host-side result
decode — the copy of device buffers to the host, a gather of their ids
through the term table and a dict built per row, the last two under the
interpreter lock that the batcher's next dispatch also needs — is handed
off through `Deferred` slots: `batch_fn` may return, per
request, a zero-argument callable wrapped in `Deferred`, and the batcher
routes it to the configured decode pool (serve/decode.py) instead of
running it inline. With a pool attached, dispatch of batch k+1 overlaps
decode of batch k and per-request futures resolve from the decode side;
without one, deferred slots are resolved inline on the batcher thread
(the synchronous mode).
"""
from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional


class BatchTimeout(TimeoutError):
    """A submitter's wall-clock deadline expired before its request
    resolved. The request itself is NOT cancelled — the batch it rides in
    keeps running — but it is marked abandoned so the decode stage can
    skip producing a result nobody will read."""


def _exc_copy(e: BaseException) -> BaseException:
    """An independent per-request copy of a batch failure, carrying the
    original raise site's traceback.

    Each request in a failed batch re-raises on its own submitter thread;
    sharing one exception instance makes those re-raises race on
    `__traceback__` (and lets one caller's handling mutate what another
    sees). copy.copy reconstructs via cls(*args), which TypeErrors for
    classes whose __init__ signature diverges from their stored args — for
    those, clone the instance structurally (__new__ + __dict__ + args).
    Only if even that fails is the original shared, as a last resort.
    """
    try:
        c = copy.copy(e)
    except Exception:
        try:
            c = e.__class__.__new__(e.__class__)
            c.__dict__.update(e.__dict__)
            c.args = e.args
        except Exception:
            return e
    if c is e:
        return e
    c.__cause__ = e.__cause__
    c.__suppress_context__ = True  # the copy has no raise context of its own
    return c.with_traceback(e.__traceback__)


class Deferred:
    """A batch_fn result slot whose finalisation (host decode) runs off the
    batcher thread: `fn()` produces the request's final result (or returns/
    raises an exception, which the submitter re-raises)."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn


@dataclasses.dataclass
class Request:
    payload: Any
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Any = None
    # submitter gave up (deadline expired): decode stages skip the work
    abandoned: bool = False
    # per-request trace (obs.Trace) or None: the batcher and decode pool
    # record the request's waits and failure paths on it (duck-typed —
    # this module stays import-free of the obs package)
    trace: Any = None
    # perf_counter stamp of the submit, taken only when a trace rides:
    # the start of the request's "queue" span
    t_submit: float = 0.0


class MicroBatcher:
    def __init__(self, batch_fn: Callable[[list[Any]], list[Any]],
                 max_batch: int, max_wait_s: float = 0.005,
                 decode_pool: Optional[Any] = None):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.decode_pool = decode_pool  # serve.decode.DecodePool (or None)
        self.q: queue.Queue[Request] = queue.Queue()
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._loop, daemon=True)
        self.t.start()
        self.n_batches = 0
        self.n_requests = 0
        self.n_deferred = 0  # result slots handed to the decode stage
        # cumulative wall time the batcher thread spent inside batch_fn
        # (group + dispatch; with a decode pool, decode is NOT in here) —
        # the open-loop bench reads this to report dispatch-stage busyness
        self.dispatch_s = 0.0
        # arrival-size histogram: batch size -> number of batches formed
        # (how much same-dispatch coalescing the traffic actually offers)
        self.batch_size_hist: dict[int, int] = {}

    def submit(self, payload: Any, timeout: float = 30.0,
               trace: Any = None) -> Any:
        r = Request(payload, trace=trace)
        if trace is not None:
            r.t_submit = time.perf_counter()
        self.q.put(r)
        if not r.event.wait(timeout):
            r.abandoned = True
            raise BatchTimeout(
                f"request did not resolve within {timeout:.3f}s"
            )
        if isinstance(r.result, BaseException):
            raise r.result
        return r.result

    def _resolve(self, r: Request, res: Any) -> None:
        """Finalize one request: deferred slots go to the decode pool (or
        run inline when none is attached), plain slots resolve now."""
        if isinstance(res, Deferred):
            self.n_deferred += 1
            if self.decode_pool is not None:
                self.decode_pool.submit(r, res.fn)
                return
            try:
                res = res.fn()
            except BaseException as e:
                res = e
        r.result = res
        r.event.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._serve(first)
            # hold nothing of a finished batch while waiting for the next:
            # freeing its (possibly large) results belongs to their
            # consumers, not to the next batch's dispatch
            del first

    def _serve(self, first: Request) -> None:
        """Collect one batch after `first`, dispatch it, resolve it."""
        batch = [first]
        deadline = time.time() + self.max_wait_s
        while len(batch) < self.max_batch:
            left = deadline - time.time()
            if left <= 0:
                break
            try:
                batch.append(self.q.get(timeout=left))
            except queue.Empty:
                break
        t0 = time.perf_counter()
        try:
            results = self.batch_fn([r.payload for r in batch])
        except BaseException as e:  # keep the worker alive: fail the
            # batch, not the server; independent per-request copies
            # (original traceback attached) so concurrent re-raises in
            # client threads never share one instance
            t1 = time.perf_counter()
            for r in batch:
                if r.trace is not None:
                    # retroactive (born-closed) span: a failed batch
                    # leaks nothing even though batch_fn blew up
                    r.trace.add_span(
                        "batch_error", t0, t1,
                        error=type(e).__name__,
                    )
            results = [_exc_copy(e) for _ in batch]
        self.dispatch_s += time.perf_counter() - t0
        for r in batch:
            if r.trace is not None:
                # submit to the hand-over of its batch to batch_fn: the
                # wait behind earlier batches plus the max_wait_s collect
                r.trace.add_span("queue", r.t_submit, t0, batch=len(batch))
        self.n_batches += 1
        self.n_requests += len(batch)
        self.batch_size_hist[len(batch)] = (
            self.batch_size_hist.get(len(batch), 0) + 1
        )
        for r, res in zip(batch, results):
            self._resolve(r, res)

    def close(self) -> None:
        self._stop.set()
        self.t.join(timeout=2)

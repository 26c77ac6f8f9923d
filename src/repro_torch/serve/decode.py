"""Serving-side decode stage.

Two residents:

- `DecodePool` — the host half of the SPARQL serving pipeline. The
  MicroBatcher thread dispatches device work and hands each request's
  finalisation (device→host transfer + row materialisation) to this
  bounded worker pool, so dispatch of batch k+1 overlaps decode of batch
  k (MapSQ's CPU/GPU split applied to the serving tier).
- `Generator` — autoregressive LM generation: prefill once, then greedy
  decode with a static-capacity KV cache (prefill_step / serve_step from
  models/transformer).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T


class DecodePool:
    """Bounded pool of daemon workers that finalise batch result slots off
    the batcher thread.

    Items are (request, fn, submit stamp) triples where `request`
    duck-types the batcher's Request (``.result``, ``.event``,
    ``.abandoned``, ``.trace``), ``fn()`` produces the request's final
    value, and the stamp (None when no trace rides) starts the request's
    ``decode_queue`` span. Crash isolation is per
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
        # the start of the request's "decode_queue" span, stamped only
        # when a trace rides
        t = (time.perf_counter()
             if getattr(request, "trace", None) is not None else None)
        self.q.put((request, fn, t))

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

    def _finish(self, r: Any, fn: Callable[[], Any],
                t_submit: "float | None" = None) -> None:
        trace = getattr(r, "trace", None)
        if t_submit is not None:
            trace.add_span("decode_queue", t_submit, time.perf_counter())
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


@dataclasses.dataclass
class Generator:
    """Greedy generation on one device. `params` (the port's params dict)
    are moved to the device once. The cache is static, (L, B, max_len, K,
    Dh), and updated in place; every step's token stays on the device
    until the end, so the decode loop makes no host sync.

    With `ranks` (a `RankContext`; its device is the one used), `params`
    hold this rank's experts (`T.shard_params`) and every rank of the
    group calls `generate` with the same prompts: the MoE layers run
    expert-parallel and every rank gets the same tokens. `moe_dropped`
    counts the MoE capacity drops of the last `start`'s prefill on this
    rank (a 0-d int64 tensor on the device)."""
    cfg: T.TransformerConfig
    params: dict
    device: Any = None
    max_len: int = 256
    ranks: Any = None

    def __post_init__(self):
        if self.ranks is not None:
            self.device = self.ranks.device
        self.device = resolve_device(self.device)
        self.params = _to_device(self.params, self.device)
        self.moe_dropped = torch.zeros((), dtype=torch.int64,
                                       device=self.device)
        self._prefill = T.make_prefill_step(self.cfg, self.ranks,
                                            self.moe_dropped)
        self._step = T.make_serve_step(self.cfg, self.ranks)

    def start(self, tokens: torch.Tensor):
        """Prefill `tokens` (B, S0) on the device into a fresh max_len
        cache. Returns (first new token (B,), kc, vc)."""
        b, s0 = tokens.shape
        kc, vc = T.init_decode_cache(self.cfg, b, self.max_len, self.device)
        self.moe_dropped.zero_()
        nxt, kc_p, vc_p = self._prefill(self.params, tokens)
        kc[:, :, :s0] = kc_p
        vc[:, :, :s0] = vc_p
        return nxt, kc, vc

    def generate_on_device(self, tokens: torch.Tensor, n_new: int) -> torch.Tensor:
        """tokens: (B, S0) int on the device. Returns (B, n_new) greedy
        tokens on the device."""
        b, s0 = tokens.shape
        if s0 + n_new > self.max_len:
            raise ValueError(f"{s0} prompt + {n_new} new tokens exceed "
                             f"max_len {self.max_len}")
        with torch.inference_mode():
            out = torch.empty((b, n_new), dtype=torch.int32, device=self.device)
            nxt, kc, vc = self.start(tokens)
            out[:, 0] = nxt
            for i in range(1, n_new):
                nxt, kc, vc = self._step(self.params, kc, vc, s0 + i - 1, nxt)
                out[:, i] = nxt
        return out

    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts: (B, S0) int32. Returns (B, n_new) greedy tokens, copied
        to the host once at the end."""
        tokens = torch.from_numpy(np.asarray(prompts, dtype=np.int32))
        out = self.generate_on_device(tokens.to(self.device), n_new)
        return out.cpu().numpy()


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}

"""Milliseconds a request's result waits for a decode worker: its
`decode_queue` span (from `DecodePool.submit` to a worker taking it up),
summed over the window's traced requests and divided by their number.
Reads the program's `obs/trace.py` spans; None where the program records
no `decode_queue` span."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    spans = [s for t in traced for s in t.find("decode_queue")]
    if not spans:
        return None
    return sum(s.duration_s for s in spans) * 1e3 / len(traced)

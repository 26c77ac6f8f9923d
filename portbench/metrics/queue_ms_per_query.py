"""Milliseconds a request waits in the server's micro-batcher: its
`queue` span (from `MicroBatcher.submit` putting it on the queue to the
hand-over of its batch to the dispatch stage, the collect wait
included), summed over the window's traced requests and divided by their
number. Reads the program's `obs/trace.py` spans; None where the program
records no `queue` span."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    spans = [s for t in traced for s in t.find("queue")]
    if not spans:
        return None
    return sum(s.duration_s for s in spans) * 1e3 / len(traced)

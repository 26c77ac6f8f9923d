"""Milliseconds of the batcher thread on the CPU while it enqueues plan
programs, a request: the `cpu_s` attribute (`time.thread_time` seconds)
of each dispatch's `enqueue` span, the child of its `dispatch` span from
the call into the program until it returns with every launch enqueued.
Counted as `dispatch_ms_per_query` counts its spans: a stacked
dispatch's lanes (one `dispatch_id`) once, a solo span on its own;
summed over the window and divided by its traced requests. Reads the
program's `obs/trace.py` spans; None where it records no `enqueue`."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    seen = {}
    for t in traced:
        for s in t.find("enqueue"):
            seen[s.attrs.get("dispatch_id", ("solo", s.span_id))] = s
    if not seen:
        return None
    return sum(s.attrs["cpu_s"] for s in seen.values()) * 1e3 / len(traced)

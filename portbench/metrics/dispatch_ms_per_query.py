"""Milliseconds of the batcher thread inside device dispatch a request:
each dispatch's `dispatch` span (from the enqueue of the plan program to
the host's read of its overflow flags, the one sync) counted once, its
stacked lanes' copies of it not again, summed over the window and divided
by its requests. Reads the program's `obs/trace.py` spans."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    seen = {}
    for t in traced:
        for s in t.find("dispatch"):
            seen[s.attrs.get("dispatch_id", ("solo", s.span_id))] = s.duration_s
    if not traced or not seen:
        return None
    return sum(seen.values()) * 1e3 / len(traced)

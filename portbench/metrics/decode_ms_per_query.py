"""Milliseconds of the decode pool a request: its `transfer` (the device
to host copy, or the wait on a batchmate's) and `decode` (rows from ids)
spans, summed over the window's requests and divided by their number.
Reads the program's `obs/trace.py` spans."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    if not traced:
        return None
    total = sum(s.duration_s for t in traced
                for name in ("transfer", "decode") for s in t.find(name))
    return total * 1e3 / len(traced)

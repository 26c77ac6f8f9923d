"""Milliseconds of the decode workers on the CPU a request: the `cpu_s`
attribute (`time.thread_time` seconds of the worker thread) of the
`transfer` and `decode` spans that `decode_ms_per_query` sums, summed
over the window's traced requests and divided by their number; the rest
of those spans' wall the workers spent off the CPU. Reads the program's
`obs/trace.py` spans; None where they carry no `cpu_s`."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    cpu = [s.attrs["cpu_s"] for t in traced
           for name in ("transfer", "decode") for s in t.find(name)
           if "cpu_s" in s.attrs]
    if not cpu:
        return None
    return sum(cpu) * 1e3 / len(traced)

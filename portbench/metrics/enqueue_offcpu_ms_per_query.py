"""Milliseconds of the batcher thread off the CPU while it enqueues plan
programs, a request: each dispatch's `enqueue` span's wall less its
`cpu_s` (`time.thread_time` seconds), the time the thread waited for the
interpreter lock or the OS scheduler, since the enqueue makes no host
sync. The same spans as `enqueue_cpu_ms_per_query`: a stacked dispatch's
lanes (one `dispatch_id`) once, a solo span on its own; summed over the
window and divided by its traced requests. Reads the program's
`obs/trace.py` spans; None where it records no `enqueue`."""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    seen = {}
    for t in traced:
        for s in t.find("enqueue"):
            seen[s.attrs.get("dispatch_id", ("solo", s.span_id))] = s
    if not seen:
        return None
    off = sum(s.duration_s - s.attrs["cpu_s"] for s in seen.values())
    return off * 1e3 / len(traced)

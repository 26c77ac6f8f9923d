"""Requests of the window over the device dispatches that served them.

A stacked dispatch fans one span named `dispatch` out to every lane it
served, all with one `dispatch_id`: it counts once. A solo dispatch's
span has no `dispatch_id` and counts on its own. Reads the program's
`obs/trace.py` spans.
"""


def read(ctx):
    traced = [r.trace for r in ctx["records"] if r.trace is not None]
    dispatches = set()
    for t in traced:
        for s in t.find("dispatch"):
            dispatches.add(s.attrs.get("dispatch_id", ("solo", s.span_id)))
    if not traced or not dispatches:
        return None
    return len(traced) / len(dispatches)

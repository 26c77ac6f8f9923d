"""Shuffles the sharded program emitted in the window, a request: every
device dispatch of the window counted once (a stacked dispatch's lanes
share one `dispatch_id` in the `obs/trace.py` spans), each with the
shuffles its plan emits a dispatch (`ExecStats.n_shuffles_emitted` over
`n_dispatches` of the template's warm run: the program counts a plan's
shuffles once a dispatch, solo or stacked), summed and divided by the
window's traced requests. Only a sharded engine has shuffles to count."""


def read(ctx):
    if not ctx["sharded"]:
        return None
    traced = [r for r in ctx["records"] if r.trace is not None]
    dispatches = {}
    for r in traced:
        for s in r.trace.find("dispatch"):
            key = s.attrs.get("dispatch_id", ("solo", s.span_id))
            dispatches[key] = r.template
    if not traced or not dispatches:
        return None
    per = [t["shuffles_per_dispatch"] for t in ctx["templates"]]
    return sum(per[k] for k in dispatches.values()) / len(traced)

"""The plan programs' share of the card's memory roofline: the least
bytes the window's answers need (portbench/roofline.py) at the H100's
3.35 TB/s, over the seconds in which a kernel ran on the card in the
window (the union of the kernels' intervals in `torch.profiler`'s trace).

Row counts are the program's own join totals from each template's warm
run (the same on every run of a template over one graph) and the data's
for each scan. Bytes count once per distinct template within
one dispatch: identical lanes of one stacked dispatch need the work once.
Only dispatches that began inside the window count."""
from portbench.roofline import H100_HBM_BYTES_PER_S, plan_bytes


def read(ctx):
    if not ctx["busy_s"]:
        return None
    t0, t1 = ctx["window"]
    work = set()
    for r in ctx["records"]:
        if r.trace is None:
            continue
        for s in r.trace.find("dispatch"):
            if t0 <= r.trace.origin + s.t0 < t1:
                work.add((s.attrs.get("dispatch_id", ("solo", s.span_id)),
                          r.template))
    if not work:
        return None
    moved = 0
    for _, k in work:
        t = ctx["templates"][k]
        b = plan_bytes(t["order"], t["scan_rows"], t["join_totals"],
                       t["select"], t["result_rows"], t["distinct"])
        if b is None:
            return None
        moved += b
    return 100.0 * moved / H100_HBM_BYTES_PER_S / ctx["busy_s"]

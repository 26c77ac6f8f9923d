"""Share of the window in which no kernel ran on the card: 100 x (1 -
union of the kernels' intervals / window), from `torch.profiler`'s trace
of the card. Copies and memsets do not count: during them alone the SMs
idle."""


def read(ctx):
    if ctx["busy_s"] is None:
        return None
    t0, t1 = ctx["window"]
    return 100.0 * (1.0 - ctx["busy_s"] / (t1 - t0))

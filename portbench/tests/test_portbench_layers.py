"""The reductions from traces to per-layer metrics: interval arithmetic,
idle gaps by host span, the plan's least bytes, and the span readers."""
import dataclasses

import numpy as np
import pytest

from portbench import devtrace, roofline
from portbench.catalog import reader
from repro_torch.obs.trace import Trace


def _grid(intervals, step=0.01, n=1000):
    g = np.zeros(n, bool)
    for a, b in intervals:
        g[int(round(a / step)):int(round(b / step))] = True
    return g


@pytest.mark.parametrize("seed", range(5))
def test_interval_sets_against_a_grid(seed):
    rng = np.random.default_rng(seed)

    def rand(k):
        pts = np.round(rng.uniform(0, 10, (k, 2)), 2)
        return [(min(a, b), max(a, b)) for a, b in pts if a != b]

    xs, ys = devtrace.merge(rand(12)), devtrace.merge(rand(9))
    gx, gy = _grid(xs), _grid(ys)
    assert np.array_equal(_grid(devtrace.intersect(xs, ys)), gx & gy)
    assert np.array_equal(_grid(devtrace.subtract(xs, ys)), gx & ~gy)
    assert devtrace.total(xs) == pytest.approx(gx.sum() * 0.01)
    assert np.array_equal(_grid(devtrace.clip(xs, 2.0, 7.5)),
                          gx & _grid([(2.0, 7.5)]))


def test_idle_gaps_go_to_the_most_specific_open_span():
    dt = devtrace.DeviceTrace(torch=None)
    dt.ops = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k3", 6.0, 7.0)]
    spans = [("dispatch", 0.5, 4.0), ("decode", 3.5, 5.0),
             ("query", 0.0, 10.0)]
    assert devtrace.total(dt.busy(0.0, 10.0)) == pytest.approx(3.0)
    gaps = dict(dt.idle_gaps(0.0, 10.0, spans))
    assert gaps["dispatch"] == pytest.approx(0.5 + 1.0)
    assert gaps["decode"] == pytest.approx(1.0)
    assert gaps["no_program_span"] == pytest.approx(0.5 + 1.0 + 3.0)
    assert dt.top_ops(0.0, 10.0)[0][0] == "k2"


def test_copies_are_not_busy_and_get_their_own_gap():
    dt = devtrace.DeviceTrace(torch=None)
    dt.ops = [("k1", 1.0, 2.0), ("Memcpy DtoH (Device -> Pageable)", 1.5, 4.0),
              ("Memset (Device)", 6.0, 6.5)]
    spans = [("decode", 3.0, 5.0)]
    assert devtrace.total(dt.busy(0.0, 10.0)) == pytest.approx(1.0)
    gaps = dict(dt.idle_gaps(0.0, 10.0, spans))
    assert gaps["copy_only"] == pytest.approx(2.0 + 0.5)
    assert gaps["decode"] == pytest.approx(1.0)
    assert gaps["no_program_span"] == pytest.approx(10.0 - 1.0 - 2.5 - 1.0)
    assert dt.top_ops(0.0, 10.0)[0] == ["Memcpy DtoH (Device -> Pageable)",
                                        pytest.approx(2.5)]


def test_plan_bytes_of_a_chain():
    order = [("?s", "<adv>", "?p"), ("?p", "<works>", "?d"),
             ("?d", "<sub>", "?u")]
    b = roofline.plan_bytes(order, [100, 10, 2], (100, 100), ("?u",), 2)
    # join 0 reads s-less left (p: 100 x 1) and (p, d) right (10 x 2),
    # writes (d) 100 x 1; join 1 reads 100 x 1 and (d, u) 2 x 2, writes
    # (u) 100 x 1; DISTINCT reads 100 x 1, writes 2 x 1
    assert b == 4 * ((100 + 20) + 100 + (100 + 4) + 100 + 100 + 2)
    assert roofline.plan_bytes(order, [1, 1, 1], (1,), ("?u",), 1) is None
    # without DISTINCT the last join's output is the answer
    assert roofline.plan_bytes(order, [100, 10, 2], (100, 100), ("?u",), 100,
                               distinct=False) == b - 4 * (100 + 2)


@dataclasses.dataclass
class _Rec:
    template: int
    trace: object


def _ctx():
    recs = []
    for lane in range(3):  # one stacked dispatch of three lanes
        t = Trace("query")
        t.add_span("dispatch", t.origin + 0.001, t.origin + 0.011,
                   dispatch_id=7, lane=lane)
        t.add_span("transfer", t.origin + 0.011, t.origin + 0.012)
        t.add_span("decode", t.origin + 0.012, t.origin + 0.014)
        recs.append(_Rec(0, t))
    t = Trace("query")  # one solo dispatch
    t.add_span("dispatch", t.origin + 0.001, t.origin + 0.005)
    recs.append(_Rec(1, t))
    return {"records": recs, "sharded": True, "busy_s": None,
            "window": (0.0, 1.0),
            "templates": [{"shuffles_per_dispatch": 2},
                          {"shuffles_per_dispatch": 0}]}


def test_span_readers():
    ctx = _ctx()
    assert reader("queries_per_dispatch")(ctx) == pytest.approx(4 / 2)
    assert reader("dispatch_ms_per_query")(ctx) == pytest.approx(
        (10 + 4) / 4, rel=1e-6)
    assert reader("decode_ms_per_query")(ctx) == pytest.approx(
        3 * 3 / 4, rel=1e-6)
    # the stacked dispatch's plan shuffles twice, once for its three lanes
    assert reader("shuffles_per_query")(ctx) == pytest.approx(2 / 4)
    assert reader("device_idle_pct")(ctx) is None
    assert reader("plan_roofline_pct")(ctx) is None
    ctx["busy_s"] = 0.25
    assert reader("device_idle_pct")(ctx) == pytest.approx(75.0)

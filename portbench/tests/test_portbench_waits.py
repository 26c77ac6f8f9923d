"""The readers of the spans that split a request's waits: the batcher's
`queue`, the plan program's `enqueue` on and off the CPU, the decode
pool's `decode_queue`, and the CPU seconds of `transfer` and `decode`."""
import dataclasses

import pytest

from portbench.catalog import reader
from repro_torch.obs.trace import Trace

WAIT_READERS = ("queue_ms_per_query", "enqueue_cpu_ms_per_query",
                "enqueue_offcpu_ms_per_query", "decode_queue_ms_per_query",
                "decode_cpu_ms_per_query")


@dataclasses.dataclass
class _Rec:
    template: int
    trace: object


def _ctx(records):
    return {"records": records, "sharded": False, "busy_s": None,
            "window": (0.0, 1.0), "templates": [{}, {}]}


def _plain_ctx():
    """A stacked dispatch of three lanes and a solo one, with only the
    spans a program that records neither the waits nor `cpu_s` has."""
    recs = []
    for lane in range(3):
        t = Trace("query")
        t.add_span("dispatch", t.origin + 0.001, t.origin + 0.011,
                   dispatch_id=7, lane=lane)
        t.add_span("transfer", t.origin + 0.011, t.origin + 0.012)
        t.add_span("decode", t.origin + 0.012, t.origin + 0.014)
        recs.append(_Rec(0, t))
    t = Trace("query")
    t.add_span("dispatch", t.origin + 0.001, t.origin + 0.005)
    recs.append(_Rec(1, t))
    return _ctx(recs)


def _waits_ctx():
    """One stacked dispatch of three lanes and one solo dispatch, with
    the spans that split their waits (times in ms from each origin)."""
    ms = 1e-3

    def request(queue, dispatch, enqueue_cpu, **attrs):
        t = Trace("query")
        o = t.origin
        t.add_span("queue", o, o + queue * ms, batch=4)
        d = t.add_span("dispatch", o + 1 * ms, o + dispatch * ms, **attrs)
        t.add_span("enqueue", o + 1 * ms, o + (dispatch - 2) * ms, parent=d,
                   cpu_s=enqueue_cpu * ms, **attrs)
        end = dispatch + 0.5
        t.add_span("decode_queue", o + dispatch * ms, o + end * ms)
        t.add_span("transfer", o + end * ms, o + (end + 1) * ms,
                   cpu_s=0.25 * ms)
        t.add_span("decode", o + (end + 1) * ms, o + (end + 3) * ms,
                   cpu_s=1.5 * ms)
        return t

    recs = [_Rec(0, request(1.0, 11, 3.0, dispatch_id=7, lane=k, width=4))
            for k in range(3)]
    recs.append(_Rec(1, request(0.5, 5, 1.0)))
    return _ctx(recs)


def test_wait_and_cpu_span_readers():
    ctx = _waits_ctx()
    read = {name: reader(name)(ctx) for name in WAIT_READERS}
    assert read["queue_ms_per_query"] == pytest.approx((3 * 1.0 + 0.5) / 4)
    # the stacked dispatch's enqueue (8 ms wall, 3 on the CPU) once for
    # its three lanes, the solo one's (2 ms wall, 1 on the CPU) on its own
    assert read["enqueue_cpu_ms_per_query"] == pytest.approx((3 + 1) / 4)
    assert read["enqueue_offcpu_ms_per_query"] == pytest.approx(
        (5 + 1) / 4)
    assert (read["enqueue_cpu_ms_per_query"]
            + read["enqueue_offcpu_ms_per_query"]) == pytest.approx((8 + 2) / 4)
    assert (read["enqueue_cpu_ms_per_query"]
            + read["enqueue_offcpu_ms_per_query"]
            <= reader("dispatch_ms_per_query")(ctx))
    assert read["decode_queue_ms_per_query"] == pytest.approx(0.5)
    assert read["decode_cpu_ms_per_query"] == pytest.approx(0.25 + 1.5)
    assert reader("decode_ms_per_query")(ctx) == pytest.approx(1 + 2)


@pytest.mark.parametrize("name", WAIT_READERS)
def test_wait_readers_read_nothing_without_their_spans(name):
    """The spans of a program that records neither the waits nor
    `cpu_s`, and no traced request at all, read None."""
    assert reader(name)(_plain_ctx()) is None
    assert reader(name)(_ctx([_Rec(0, None)])) is None

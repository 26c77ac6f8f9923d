"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result.

Set-up makes the graph from the seed, builds the program's store, engine
and server as the configuration states, and runs every template of the mix solo and stacked at every
batch width the server can form, then one burst through the server, so
nothing calibrates or compiles inside the window. The window is a closed
loop: each client sends its next request
when the last one returned, until the window closes; requests still out
then are waited for. After the window the program is closed and freed,
and the reference answers each template once; every request's answer is
then held to it.

Numbers compared, each with the limit 0 (an exact comparison):
  wrong_requests  requests of the window that failed, never came, or
                  whose row count or variables differ from the reference
  wrong_rows      over a sample of requests drawn from the seed, rows the
                  answer lacks plus rows it has beyond the reference's,
                  row by row, each row as often as it occurs (a bag, or
                  a set under DISTINCT)
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import sys
import threading
import time

import numpy as np

from portbench import lubmgen, mix, reference
from portbench.catalog import Cell, reader

GIB = float(1 << 30)
# set-up's requests may wait on lazy imports and calibration
WARM_TIMEOUT_MS = 600_000.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Record:
    template: int
    t0: float
    t1: float
    ok: bool
    n_rows: int = -1
    vars: tuple = ()
    trace: object = None


@dataclasses.dataclass
class Setup:
    cell: Cell
    graph: lubmgen.Graph
    templates: list[mix.Template]
    phases: dict[str, float]
    query: object  # text -> an answer with .rows and .vars
    server: object = None  # the program's SPARQLServer (None for a stand-in)
    engine: object = None
    counts: list = dataclasses.field(default_factory=list)  # per template


def build_program(cell: Cell, graph, device, tracer, phases) -> tuple:
    """The configuration's store, engine and server over `graph`."""
    from repro_torch.sparql.dictionary import TermDict
    from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
    from repro_torch.sparql.sharded_store import ShardedTripleStore
    from repro_torch.sparql.store import TripleStore
    from repro_torch.serve.sparql_server import SPARQLServer

    cfg = cell.config
    t = time.perf_counter()
    shards = int(cfg.get("shards", 0))
    if shards:
        d = TermDict()
        for tid, term in enumerate(graph.terms):
            if d.encode(term) != tid:
                raise ValueError(f"duplicate term {term!r}")
        store = ShardedTripleStore(graph.triples, d, shards)
    else:
        store = TripleStore.from_arrays(graph.triples, graph.terms)
    phases["store_build"] = time.perf_counter() - t
    t = time.perf_counter()
    store.statistics  # noqa: B018 - the optimizer's catalog, built once
    phases["statistics"] = time.perf_counter() - t
    if shards:
        engine = ShardedQueryEngine(store, device=device, tracer=tracer)
    else:
        engine = QueryEngine(store, device=device, tracer=tracer)
    server = SPARQLServer(engine, **cfg.get("server", {}))
    return engine, server


def _burst(query, texts: list[str], clients: int) -> None:
    """Every text once, `clients` at a time, through `query`."""
    errors: list[BaseException] = []

    def one(chunk):
        for text in chunk:
            try:
                query(text)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    chunks = [texts[i::clients] for i in range(clients)]
    threads = [threading.Thread(target=one, args=(c,)) for c in chunks]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError(f"warm-up request failed: {errors[0]!r}")


def warm(setup: Setup) -> None:
    """Every template solo (cold, then warm) and stacked at each width a
    micro-batch can form, then one burst through the server. The warm solo
    run's counts are kept for the per-layer readers: the plan's scan order,
    its joins' exact totals, the answer's size and the shuffles the sharded
    program emits a dispatch (the server's answers carry no counts)."""
    from repro_torch.sparql.optimizer import optimize
    from repro_torch.sparql.parser import parse

    eng, srv = setup.engine, setup.server
    for tp in setup.templates:
        t = time.perf_counter()
        pq = eng.prepare(tp.text)
        pq.run()  # cold: calibrates and builds the plan program
        rs = pq.run()
        srv.query(tp.text, timeout_ms=WARM_TIMEOUT_MS)  # the server's handle
        plan = optimize(parse(tp.text), eng.store, enabled=eng.optimize,
                        n_shards=getattr(eng, "n_shards", 1))
        setup.counts.append({
            "name": tp.name,
            "select": tp.select,
            "distinct": tp.distinct,
            "order": [(p.s, p.p, p.o) for p in plan.all_patterns()],
            "join_totals": tuple(rs.stats.join_totals),
            "result_rows": len(rs.rows),
            "shuffles_per_dispatch": (rs.stats.n_shuffles_emitted
                                      / max(1, rs.stats.n_dispatches)),
        })
        width = 2
        while width <= srv.max_batch:
            eng.run_batch([pq] * width)
            width *= 2
        log(f"warm {tp.name}: {time.perf_counter() - t:.3f} s")
    clients = int(setup.cell.traffic["clients"])
    t = time.perf_counter()
    _burst(lambda text: srv.query(text, timeout_ms=WARM_TIMEOUT_MS),
           [tp.text for tp in setup.templates] * clients, clients)
    log(f"warm burst: {time.perf_counter() - t:.3f} s")


def setup_cell(cell: Cell, seed: int, device, trace: bool,
               scale: "int | None" = None, stand_in=None) -> Setup:
    """Set-up of one run. `stand_in(graph, templates)` puts another
    answerer in the program's place (the control); `scale` overrides the
    configuration's universities (tests only)."""
    phases: dict[str, float] = {}
    t = time.perf_counter()
    graph = lubmgen.generate(
        scale or cell.config["universities"], seed,
        lubmgen.Sizes.from_config(cell.config))
    phases["generate"] = time.perf_counter() - t
    templates = mix.templates(cell.traffic)
    if stand_in is not None:
        return Setup(cell, graph, templates, phases,
                     stand_in(graph, templates))
    import torch

    from repro_torch import kernels
    from repro_torch.obs.trace import Tracer

    dev = torch.device(device)
    if dev.type == "cuda":
        t = time.perf_counter()
        kernels.build_all()
        phases["kernel_build"] = time.perf_counter() - t
    tracer = Tracer(ring_size=1 << 22) if trace else None
    engine, server = build_program(cell, graph, dev, tracer, phases)
    setup = Setup(cell, graph, templates, phases, server.query, server,
                  engine)
    t = time.perf_counter()
    try:
        warm(setup)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    except BaseException:
        server.close()
        raise
    phases["warm_up"] = time.perf_counter() - t
    return setup


class Sample:
    """A seeded reservoir of answers per template, kept whole for the
    row-by-row comparison; every other answer is dropped on arrival."""

    def __init__(self, n_templates: int, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7919])
        self.seen = [0] * n_templates
        self.kept: list[list] = [[] for _ in range(n_templates)]
        self.lock = threading.Lock()

    def offer(self, template: int, answer) -> None:
        with self.lock:
            i = self.seen[template]
            self.seen[template] += 1
            kept = self.kept[template]
            if i < self.k:
                kept.append(answer)
            else:
                j = int(self.rng.integers(0, i + 1))
                if j < self.k:
                    kept[j] = answer


def window(setup: Setup, seed: int, seconds: float, on_start=None):
    """The closed loop. Returns (records, sample, t0, t_close)."""
    traffic = setup.cell.traffic
    n_clients = int(traffic["clients"])
    sample = Sample(len(setup.templates), int(traffic["sample_per_template"]),
                    seed)
    records: list[list[Record]] = [[] for _ in range(n_clients)]
    tracer = setup.engine.tracer if setup.engine is not None else None
    start = threading.Barrier(n_clients + 1)
    bounds = {}

    idents = [0] * n_clients

    def client(c: int) -> None:
        seq = mix.client_sequence(traffic, seed, c)
        out = records[c]
        idents[c] = threading.get_ident()
        start.wait()
        t_close = bounds["close"]
        while True:
            k = next(seq)
            t0 = time.perf_counter()
            if t0 >= t_close:
                return
            try:
                ans = setup.query(setup.templates[k].text)
            except Exception:  # noqa: BLE001 - a failed request counts
                out.append(Record(k, t0, time.perf_counter(), False))
                continue
            t1 = time.perf_counter()
            out.append(Record(k, t0, t1, True, len(ans.rows),
                              tuple(ans.vars)))
            sample.offer(k, ans)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for th in threads:
        th.start()
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    bounds["close"] = t0 + seconds
    start.wait()
    for th in threads:
        th.join()
    flat = [r for rs in records for r in rs]
    if tracer is not None:
        _attach_traces(tracer.recent(), records, idents)
    return flat, sample, t0, t0 + seconds


def _attach_traces(traces, records, idents) -> None:
    """Each request's trace: the one its client's thread started while
    the request was out."""
    import bisect

    by_thread: dict[int, list] = {}
    for t in traces:
        by_thread.setdefault(t.root.thread, []).append(t)
    for c, rs in enumerate(records):
        mine = sorted(by_thread.get(idents[c], ()), key=lambda t: t.origin)
        origins = [t.origin for t in mine]
        for r in rs:
            i = bisect.bisect_left(origins, r.t0)
            if i < len(mine) and origins[i] <= r.t1:
                r.trace = mine[i]


def p95_ms(records: list[Record]) -> float:
    """The 95th percentile of every request's latency; a failed request
    never answered, so it counts as infinite."""
    lat = [(r.t1 - r.t0) * 1e3 if r.ok else math.inf for r in records]
    return float(np.percentile(lat, 95)) if lat else math.inf


def compare(setup: Setup, records, sample) -> tuple[dict, int, list[bool]]:
    """The reference's answer to each template, then every request held
    to it. Returns ({name: (value, limit)}, the number of requests
    compared row by row, whether each record's answer held)."""
    data = reference.Triples(setup.graph.triples, setup.graph.terms)
    terms = np.asarray(setup.graph.terms, dtype=object)
    expect = []
    for tp in setup.templates:
        ids = reference.evaluate(data, list(tp.patterns), list(tp.select),
                                 tp.distinct)
        expect.append(collections.Counter(map(tuple, terms[ids].tolist())))
    sizes = [sum(e.values()) for e in expect]
    good = [r.ok and r.n_rows == sizes[r.template]
            and r.vars == setup.templates[r.template].select
            for r in records]
    wrong_requests = len(records) - sum(good)
    wrong_rows = 0
    n = 0
    verdicts: dict[int, int] = {}  # one answer object shared is read once
    for k, answers in enumerate(sample.kept):
        sel = setup.templates[k].select
        for ans in answers:
            n += 1
            if id(ans) not in verdicts:
                got = collections.Counter(
                    tuple(row.get(v) for v in sel) for row in ans.rows)
                verdicts[id(ans)] = (sum((expect[k] - got).values())
                                     + sum((got - expect[k]).values()))
            wrong_rows += verdicts[id(ans)]
    return ({"wrong_requests": (wrong_requests, 0),
             "wrong_rows": (wrong_rows, 0)}, n, good)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & bad)


def _host_spans(records) -> list[tuple[str, float, float]]:
    spans = []
    seen = set()
    for r in records:
        t = r.trace
        if t is None or t.trace_id in seen:
            continue
        seen.add(t.trace_id)
        for s in list(t.spans):
            if s.parent_id is not None and not s.open:
                spans.append((s.name, t.origin + s.t0, t.origin + s.t1))
    return spans


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        scale=None, stand_in=None, fault=None, t_start=None) -> dict:
    """One whole run; returns the result line's object. `fault()`, a
    context manager, breaks the program for the window (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = stand_in is None and str(device).startswith("cuda")
    if on_card:
        import torch

        torch.cuda.reset_peak_memory_stats()
    setup = setup_cell(cell, seed, device, trace, scale, stand_in)
    try:
        return _measure(setup, seed, seconds, trace, on_card, fault, t_start)
    finally:
        if setup.server is not None:
            setup.server.close()


def _measure(setup: Setup, seed, seconds, trace, on_card, fault, t_start):
    cell = setup.cell
    for name, s in setup.phases.items():
        log(f"setup phase {name}: {s:.3f} s")
    devtrace = None
    if on_card:
        import torch

        if trace:
            from portbench.devtrace import DeviceTrace

            devtrace = DeviceTrace(torch)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s: {setup_s:.3f} s")
    if on_card:
        log(f"device memory peak after set-up: "
            f"{torch.cuda.max_memory_allocated() / GIB:.3f} GiB")
    gc_before = [d["collections"] for d in gc.get_stats()]
    with fault() if fault is not None else contextlib.nullcontext():
        records, sample, t0, t_close = window(
            setup, seed, seconds,
            on_start=devtrace.start if devtrace is not None else None)
    if devtrace is not None:
        devtrace.stop()
    log("garbage collections in the window, by generation: " + str(
        [d["collections"] - b for d, b in zip(gc.get_stats(), gc_before)]))
    window_s = t_close - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        log(f"device memory peak after the window: {peak / GIB:.3f} GiB, "
            f"in use {torch.cuda.memory_allocated() / GIB:.3f} GiB")
    ctx = layer_context(setup, records, t0, t_close, devtrace) if trace else None
    # the reference runs once the program is closed and its memory freed
    if setup.server is not None:
        setup.server.close()
    setup.server = setup.engine = setup.query = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, n_compared, good = compare(setup, records, sample)
    n_by_template: dict[int, int] = {}
    for r in records:
        n_by_template[r.template] = n_by_template.get(r.template, 0) + 1
    log("requests by template: " + ", ".join(
        f"{setup.templates[k].name} {n}"
        for k, n in sorted(n_by_template.items())))
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": len(records),
        "failed": sum(1 for r in records if not r.ok),
        "metrics": {},
        "device": device_info(on_card, cell.chips, peak),
    }
    if trace:
        result["metrics"] = read_layers(cell, ctx)
        if devtrace is not None:
            result["device"]["busy_s"] = ctx["busy_s"]
            result["device"]["window_s"] = window_s
            result["breakdown"] = {
                "device_ops": devtrace.top_ops(t0, t_close),
                "idle_gaps": devtrace.idle_gaps(t0, t_close,
                                                ctx["host_spans"]),
            }
    else:
        values = {
            "qps": sum(1 for r, g in zip(records, good)
                       if g and r.t1 <= t_close) / window_s,
            "p95_ms": p95_ms(records),
            "peak_device_gib": peak / GIB,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    log(f"compared row by row: {n_compared} requests")
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} limit {lim}")
    return result


def device_info(on_card: bool, chips: int, peak: int) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def layer_context(setup: Setup, records, t0, t_close, devtrace) -> dict:
    """What the per-layer readers read: the window's requests with their
    traces, the host spans, the device's busy intervals (kernels only),
    and per template the program's own counts from its warm solo run in
    set-up."""
    data = reference.Triples(setup.graph.triples, setup.graph.terms)
    templates = [dict(c, scan_rows=[len(data.scan(p)[1]) for p in c["order"]])
                 for c in setup.counts]
    busy = devtrace.busy(t0, t_close) if devtrace is not None else None
    return {
        "records": records,
        "window": (t0, t_close),
        "templates": templates,
        "sharded": bool(setup.cell.config.get("shards", 0)),
        "host_spans": _host_spans(records),
        "busy": busy,
        "busy_s": sum(b - a for a, b in busy) if busy is not None else None,
    }


def read_layers(cell: Cell, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out

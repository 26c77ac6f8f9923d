"""The sharded engine across processes, on the CPU with gloo: the rank
context's host rules, and the rank-side programs the other
test_torch_dist_* files spawn.

A group of ranks is spawned (`run_ranks`) with a file:// rendezvous in
the test's tmp_path, so no ports clash under xdist; every process group
times out after RANK_TIMEOUT and the parent kills a rank that outlives
its join, so a hung group fails in under a minute. Each rank pickles its
result into the tmp_path; the parent holds them to the one-process
functions and engines. The rank programs live in this file, which
imports no JAX: the spawned ranks import it."""
import dataclasses
import datetime
import os
import pickle
import time
import traceback
import uuid

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as dj
from repro_torch.core import ranks as rk
from repro_torch.core.relation import Relation

RANK_TIMEOUT = datetime.timedelta(seconds=45)


# -- spawning a group ----------------------------------------------------------


def run_ranks(tmp_path, world: int, program: str, *args,
              axis_sizes=None, axis_names=("shards",), device="cpu",
              backend=None, timeout: float = 240.0) -> list:
    """Run `program` (a function of this file, or "module:function",
    called as program(ranks, *args)) on `world` spawned ranks; returns
    each rank's result, rank order. Fails on any rank's error, exit code
    or hang."""
    import torch.multiprocessing as mp

    tag = uuid.uuid4().hex[:8]
    out = tmp_path / f"ranks-{tag}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(rank, world, str(out), program, args, axis_sizes,
                  axis_names, device, backend, RANK_TIMEOUT),
        )
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    errors = {
        r: (out / f"{r}.err").read_text()
        for r in range(world) if (out / f"{r}.err").exists()
    }
    codes = [p.exitcode for p in procs]
    assert not hung and not errors and codes == [0] * world, (
        hung, codes, errors)
    return [pickle.loads((out / f"{r}.pkl").read_bytes())
            for r in range(world)]


def _program(name: str):
    """A rank program: a function of this file, or "module:function" of
    another importable module (the tests' directory is on the path)."""
    if ":" not in name:
        return globals()[name]
    import importlib

    module, func = name.split(":")
    return getattr(importlib.import_module(module), func)


def _rank_main(rank, world, out, program, args, axis_sizes, axis_names,
               device, backend, timeout):
    """One spawned rank: join the group, run the program, leave."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)  # the ranks share the test machine's cores
    try:
        ranks = rk.init_ranks(
            device=device, backend=backend, axis_sizes=axis_sizes,
            axis_names=axis_names,
            init_method=f"file://{out}/rendezvous", timeout=timeout,
        )
        try:
            result = _program(program)(ranks, *args)
        finally:
            ranks.close()
        with open(f"{out}/{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(f"{out}/{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


# -- the exchanges --------------------------------------------------------------

LANES = 2


def exchange_outputs(mesh: dj.ShardMesh, seed: int) -> dict:
    """The exchanges of core/distributed.py on seeded inputs, for the
    shards this process holds (every shard, or across ranks its own):
    numpy arrays whose leading axis is (LANES * local_shards). The same
    draws in every process, so the blocks of one run line up with the
    shards of another."""
    s = mesh.n_shards
    rank = None if mesh.ranks is None else mesh.ranks.rank
    rng = np.random.RandomState(seed)

    device = "cpu" if mesh.ranks is None else mesh.ranks.device

    def own(x: np.ndarray) -> torch.Tensor:
        """Global (LANES * s, ...) lane-major -> this process's shards."""
        if rank is not None:
            x = np.ascontiguousarray(x.reshape(LANES, s, *x.shape[1:])[:, rank])
        return torch.from_numpy(x).to(device)

    out = {}
    for axis in mesh.axis_names:
        size = mesh.axis_size(axis)
        buf = rng.randint(-99, 99, size=(LANES * s, size, 3, 2)).astype(np.int32)
        out[f"all_to_all/{axis}"] = (
            dj.all_to_all(own(buf), mesh, axis).cpu().numpy())
    rows = rng.randint(-99, 99, size=(LANES * s, 5, 3)).astype(np.int32)
    valid = rng.rand(LANES * s, 5) < 0.6
    out["all_gather"] = dj.all_gather(own(rows), mesh).cpu().numpy()
    out["all_gather/bool"] = dj.all_gather(own(valid), mesh).cpu().numpy()
    gathered = dj.gather_shards(own(rows), mesh)
    out["gather_shards"] = gathered.cpu().numpy()
    out["own_shards"] = dj.own_shards(
        gathered.reshape(LANES, s, 5, 3), mesh).cpu().numpy()
    rel = dj.gather_relation(
        Relation(("?a", "?b", "?c"), own(rows), own(valid)), mesh)
    out["gather_relation"] = (rel.cols.cpu().numpy(),
                              rel.valid.cpu().numpy())
    keys = rng.randint(0, 12, size=(LANES * s, 24, 2)).astype(np.int32)
    kvalid = rng.rand(LANES * s, 24) < 0.8
    caps = tuple(16 for _ in mesh.axis_sizes)
    out["shuffle_by_key"] = tuple(
        x.cpu().numpy() for x in dj.shuffle_by_key(
            own(keys), own(kvalid), [0], mesh, caps))
    small = tuple(2 for _ in mesh.axis_sizes)
    out["shuffle_by_key/overflow"] = tuple(
        x.cpu().numpy() for x in dj.shuffle_by_key(
            own(keys), own(kvalid), [0, 1], mesh, small))
    return out


def join_inputs(n_shards: int, seed: int):
    """dist_join_prog.py's inputs: two random (key, value) relations, flat
    and padded to whole per-shard blocks."""
    rng = np.random.RandomState(seed)
    l_rows = rng.randint(0, 12, size=(rng.randint(8, 60), 2)).astype(np.int32)
    r_rows = rng.randint(0, 12, size=(rng.randint(8, 60), 2)).astype(np.int32)

    def pad(n: int) -> int:
        return -(-max(n, 1) // n_shards) * n_shards

    left = Relation.from_numpy(("?k", "?a"), l_rows, capacity=pad(len(l_rows)))
    right = Relation.from_numpy(("?k", "?b"), r_rows, capacity=pad(len(r_rows)))
    return l_rows, r_rows, left, right


def on(rel: Relation, device) -> Relation:
    return Relation(rel.schema, rel.cols.to(device), rel.valid.to(device))


def join_outputs(mesh: dj.ShardMesh, seed: int):
    """make_distributed_join on join_inputs(seed), for this process's
    shards: (cols, valid, per-shard totals, per-shard flags)."""
    s = mesh.n_shards
    _, _, left, right = join_inputs(s, seed)
    if mesh.ranks is not None:
        left, right = on(left, mesh.ranks.device), on(right, mesh.ranks.device)
        r = mesh.ranks.rank

        def block(rel: Relation) -> Relation:
            n = rel.capacity // s
            return Relation(rel.schema, rel.cols[r * n:(r + 1) * n],
                            rel.valid[r * n:(r + 1) * n])

        left, right = block(left), block(right)
    fn = dj.make_distributed_join(mesh, 64, 256, left.schema, right.schema)
    out, totals, ov = fn(left, right)
    return tuple(x.cpu().numpy() for x in (out.cols, out.valid, totals, ov))


SEEDS = (0, 1, 2)


def exchange_prog(ranks) -> dict:
    """Every exchange and the distributed join on this rank's shard."""
    return {
        seed: {"exchanges": exchange_outputs(ranks.mesh, seed),
               "join": join_outputs(ranks.mesh, seed)}
        for seed in SEEDS
    }


# -- the engine -----------------------------------------------------------------


def stats_fields(st) -> dict:
    """An ExecStats' fields that every rank and every placement must
    agree on: all but the host clock and the decode's row count (only
    rank 0 decodes)."""
    d = dataclasses.asdict(st)
    del d["device_time_s"], d["rows_emitted"]
    return d


def outcome_fields(outcome):
    """A call's outcome as rank 0 and a follower both record it."""
    if isinstance(outcome, Exception):
        return type(outcome).__name__
    if isinstance(outcome, list):
        return [outcome_fields(o) for o in outcome]
    if outcome is None:
        return None
    if hasattr(outcome, "inserted"):
        return dataclasses.astuple(outcome)
    return stats_fields(outcome)


def cache_state(engine) -> dict:
    """What lockstep keeps equal on every rank: the plan cache's
    signatures and counters and the stacked-dispatch counters."""
    return {
        "entries": [engine._entry_jsonable(e)
                    for e in engine.plan_cache.entries()],
        "plan_cache": engine.plan_cache.stats(),
        "stacked": (engine.stacked_dispatches, engine.stacked_queries,
                    dict(engine.batch_width_hist)),
        "store": engine.store.write_stats(),
    }


def save_store(store, path) -> str:
    """A store's triples and terms, for the ranks to load."""
    d = store.dictionary
    terms = np.array([d.decode(i) for i in range(len(d))])
    np.savez(path, triples=store.triples, terms=terms)
    return str(path)


def engine_script(d, make_engine, queries: dict, batch: list, update: str,
                  after_update: str, retry: tuple) -> dict:
    """drive()'s script, with its warmup file at the smallest join and
    shuffle buckets (from a one-process engine's cache of the `retry`
    queries): every rank reads it, so every rank retries alike."""
    import json

    eng = make_engine(None, None)
    for name in retry:
        eng.query(queries[name])
    small = d / "small.json"
    eng.save_cache(str(small))
    data = json.loads(small.read_text())
    for e in data["entries"]:
        e["join_caps"] = [8] * len(e["join_caps"])
        e["shuffle_caps"] = [8] * len(e["shuffle_caps"])
    small.write_text(json.dumps(data))
    return {"queries": queries, "batch": batch, "update": update,
            "after_update": after_update, "retry": retry,
            "warmup": str(small), "max_capacity": 16,
            "save": str(d / "saved.json")}


def load_store(path: str, n_shards: int):
    """The sharded store over the triples and terms a test wrote."""
    from repro_torch.sparql.sharded_store import shard_store
    from repro_torch.sparql.store import TripleStore

    data = np.load(path, allow_pickle=False)
    base = TripleStore.from_arrays(data["triples"], list(data["terms"]))
    return shard_store(base, n_shards)


def drive(make_engine, script: dict) -> dict:
    """The calls one engine gets, in order (rank 0 of a group, or the
    one-process engine beside it): per query, execute cold and warm (its
    arrays and stats) and prepare().run() (its rows); a run_batch group
    twice; an update and a query that reads it; save_cache. Then an
    engine whose warmup file holds the smallest buckets (forced
    retries), and one whose max_capacity the regrow passes. `calls`
    records each call's outcome as a follower records it."""
    from repro_torch.sparql.parser import parse

    rec = {"queries": {}, "calls": [], "batches": [], "engines": []}
    calls = rec["calls"]

    def call(method, fn):
        try:
            value, outcome = fn()
        except MemoryError as e:  # past max_capacity: the engine goes on
            calls.append((method, type(e).__name__))
            return e
        calls.append((method, outcome_fields(outcome)))
        return value

    def run(pq):
        return call("run", lambda: (lambda rs: (rs, [rs.stats]))(pq.run()))

    eng = make_engine(None, None)
    for name, text in script["queries"].items():
        q = parse(text)
        runs = []
        for _ in range(2):
            rel, st = call("execute", lambda: (lambda r: (r, [r[1]]))(
                eng.execute(q)))
            runs.append(stats_fields(st))
        rs = run(eng.prepare(text))
        rec["queries"][name] = {
            "cols": rel.cols.cpu().numpy(), "valid": rel.valid.cpu().numpy(),
            "cold": runs[0], "warm": runs[1], "run": stats_fields(rs.stats),
            "rows": rs.rows,
        }
    for _ in range(2):
        out = call("run_batch", lambda: (lambda o: (o, [r.stats for r in o]))(
            eng.run_batch([eng.prepare(t) for t in script["batch"]])))
        rec["batches"].append({
            "rows": [r.rows for r in out],
            "groups": [dataclasses.astuple(g) for g in eng.last_batch],
        })
    upd = call("update", lambda: (lambda u: (u, u))(
        eng.update(script["update"])))
    rec["update"] = dataclasses.astuple(upd)
    rec["after_update"] = run(eng.prepare(script["after_update"])).rows
    call("save_cache", lambda: (eng.save_cache(script["save"]), None))
    rec["engines"].append(cache_state(eng))
    eng.close()
    for warmup, cap in ((script["warmup"], None),
                        (script["warmup"], script["max_capacity"])):
        eng = make_engine(warmup, cap)
        for name in script["retry"]:
            got = run(eng.prepare(script["queries"][name]))
            rec["queries"][name]["retry" if cap is None else "capped"] = (
                type(got).__name__ if isinstance(got, Exception)
                else (got.rows, stats_fields(got.stats)))
        call("save_cache", lambda: (eng.save_cache(script["save"]), None))
        rec["engines"].append(cache_state(eng))
        eng.close()
    return rec


def engine_prog(ranks, data_path: str, script: dict) -> dict:
    """The engine on one shard per rank: rank 0 drives, the others
    follow, each engine of drive() in turn."""
    from repro_torch.sparql.engine import ShardedQueryEngine

    def make_engine(warmup, max_capacity):
        kw = {} if max_capacity is None else {"max_capacity": max_capacity}
        return ShardedQueryEngine(
            load_store(data_path, ranks.world_size), ranks=ranks,
            warmup_path=warmup, **kw)

    # where the scans live: this rank's shard alone, at the shared bucket
    eng = make_engine(None, None)
    placement = []
    for tp in eng.prepare(script["queries"]["Q9"])._program.patterns:
        scan = eng._device_scan(tp)
        placement.append((int(scan.valid.sum()), scan.capacity,
                          eng.store.per_shard_counts(tp),
                          eng.store.scan_capacity(tp)))
    if ranks.rank == 0:
        return dict(drive(make_engine, script), placement=placement)
    rec = {"calls": [], "engines": [], "placement": placement}
    for warmup, cap in ((None, None), (script["warmup"], None),
                        (script["warmup"], script["max_capacity"])):
        eng = make_engine(warmup, cap)
        eng.follow(lambda m, o: rec["calls"].append((m, outcome_fields(o))))
        rec["engines"].append(cache_state(eng))
    return rec


# -- the rank context's own rules ------------------------------------------------


def test_backend_follows_the_device():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert rk.backend_for(cpu, None) == "gloo"
    assert rk.backend_for(card, None) == "nccl"
    assert rk.backend_for(card, "gloo") == "gloo"  # ranks sharing a card
    with pytest.raises(ValueError):
        rk.backend_for(cpu, "nccl")
    with pytest.raises(ValueError):
        rk.backend_for(cpu, "mpi")


def test_init_ranks_needs_the_launchers_environment(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        rk.init_ranks(device="cpu")


def test_init_ranks_refuses_a_mesh_that_does_not_hold_the_world(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="does not hold"):
        rk.init_ranks(device="cpu", axis_sizes=(2, 3),
                      axis_names=("pod", "data"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rk.init_ranks()  # cuda:LOCAL_RANK, and no card: no fallback


def test_the_rank_mesh_equals_a_plain_mesh_of_its_axes():
    """The context rides on the mesh without being a field of it."""
    plain = dj.make_mesh((2, 2), ("pod", "data"))
    bound = dj.make_mesh((2, 2), ("pod", "data"))
    object.__setattr__(bound, "ranks", "context")
    assert bound == plain and hash(bound) == hash(plain)
    assert plain.ranks is None and plain.local_shards == 4
    assert bound.local_shards == 1
    assert [f.name for f in dataclasses.fields(dj.ShardMesh)] == [
        "axis_sizes", "axis_names"]


def lone_prog(ranks) -> tuple:
    return ranks.rank, ranks.world_size, ranks.backend, str(ranks.device)


def test_a_rank_without_its_peers_fails_inside_its_timeout(tmp_path):
    """Rank 0 of two, with rank 1 never started: the rendezvous raises
    after the group's timeout (no hang, no fallback to one process)."""
    import torch.multiprocessing as mp

    p = mp.get_context("spawn").Process(
        target=_rank_main,
        args=(0, 2, str(tmp_path), "lone_prog", (), None, ("shards",),
              "cpu", None, datetime.timedelta(seconds=3)),
    )
    t = time.monotonic()
    p.start()
    p.join(50)
    alive = p.is_alive()
    if alive:
        p.kill()
        p.join(10)
    assert not alive and p.exitcode != 0
    assert time.monotonic() - t < 50
    err = (tmp_path / "0.err").read_text()
    assert "imeout" in err or "timed out" in err, err
    assert not (tmp_path / "0.pkl").exists()

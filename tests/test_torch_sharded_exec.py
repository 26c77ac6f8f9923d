"""The port's distributed executor against the reference's: the host-side
partitioning analysis (strategies, shuffle sites and caps) on the
reference's partitioning plans and on the LUBM plans, the optimizer's
shard-aware join order, and the shard-axis exchanges against a numpy
re-derivation on a 4-shard and a 2 x 2 mesh."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core import dist_executor as j_dx
from repro.core import plan_ir as j_ir
from repro.sparql import lubm as j_lubm
from repro.sparql import optimizer as j_opt
from repro.sparql import sharded_store as j_ss
from repro.sparql.parser import parse as j_parse
from repro_torch.core import dist_executor as t_dx
from repro_torch.core import distributed as t_dist
from repro_torch.core import mr_join as t_mj
from repro_torch.core import plan_ir as t_ir
from repro_torch.core.relation import Relation
from repro_torch.sparql import optimizer as t_opt
from repro_torch.sparql import sharded_store as t_ss
from repro_torch.sparql.engine import ShardedQueryEngine
from repro_torch.sparql.parser import parse as t_parse
from repro_torch.sparql.store import TripleStore

from test_torch_engine_default import QUERIES  # noqa: E402


# -- the reference's partitioning plans, built in both plan IRs --------------


def _plans(ir):
    """tests/test_partitioning.py's plans as (name, plan, n_shards,
    broadcast_rows) in plan IR module `ir`."""

    def scan(index, schema, cap=64, part_col=-1):
        return ir.Scan(index=index, schema=tuple(schema), capacity=cap,
                       part_col=part_col)

    def join(left, right, key, cap=128, cls=ir.MRJoin):
        schema = tuple(left.schema) + tuple(
            v for v in right.schema if v not in left.schema
        )
        return cls(left=left, right=right, key_vars=tuple(key),
                   schema=schema, capacity=cap)

    def plan_of(root, n_scans=2, n_joins=1):
        return ir.PhysicalPlan(root=root, n_scans=n_scans,
                               join_caps=(128,) * n_joins)

    star = join(scan(0, ("?x", "?a"), part_col=0),
                scan(1, ("?x", "?b"), part_col=0), ("?x",))
    chain = join(scan(0, ("?x", "?y"), part_col=0),
                 scan(1, ("?y", "?z"), part_col=0), ("?y",))
    up = join(scan(0, ("?a", "?b"), part_col=0),
              scan(1, ("?a", "?b", "?c"), part_col=0), ("?a", "?b"))
    first = join(scan(0, ("?x", "?y"), part_col=0),
                 scan(1, ("?z", "?y"), part_col=0), ("?y",))
    small = join(scan(0, ("?x", "?y"), part_col=0),
                 scan(1, ("?z", "?y"), part_col=0, cap=16), ("?y",))
    a = scan(0, ("?x", "?v"), part_col=0)
    b = scan(1, ("?x", "?v"), part_col=0)
    cross = ir.CrossJoin(left=scan(0, ("?x",), part_col=0),
                         right=scan(1, ("?y",)), schema=("?x", "?y"),
                         capacity=64 * 64)
    left = ir.LeftJoin(left=chain, right=scan(2, ("?y", "?w")),
                       key_vars=("?y",), schema=("?x", "?y", "?z", "?w"),
                       join_cap=256)
    sliced = ir.Slice(child=ir.Distinct(child=ir.Project(
        child=chain, schema=("?y", "?z"))), offset_index=0, limit_index=1)
    out = [
        ("star", plan_of(star), 4, 2048),
        ("chain", plan_of(chain), 4, 2048),
        ("single", plan_of(join(scan(0, ("?x", "?y")),
                                scan(1, ("?y", "?z")), ("?y",))), 1, 2048),
        ("aligned", plan_of(join(up, scan(2, ("?a", "?b", "?d")),
                                 ("?a", "?b"), cap=256), 3, 2), 4, 0),
        ("swapped", plan_of(join(up, scan(2, ("?a", "?b", "?d")),
                                 ("?b", "?a"), cap=256), 3, 2), 4, 0),
        ("on_key", plan_of(join(first, scan(2, ("?y", "?w"), part_col=0),
                                ("?y",), cap=256), 3, 2), 4, 0),
        ("matrix", plan_of(join(scan(0, ("?x", "?a"), part_col=0),
                                scan(1, ("?x", "?b"), part_col=0), ("?x",),
                                cls=ir.MatrixJoin)), 4, 2048),
        ("broadcast", plan_of(small), 4, 2048),
        ("no_broadcast", plan_of(small), 4, 32),
        ("keeps_left", plan_of(join(small, scan(2, ("?x", "?w"), part_col=0),
                                    ("?x",), cap=256), 3, 2), 4, 2048),
        ("project_keeps", plan_of(ir.Distinct(child=ir.Project(
            child=star, schema=("?x", "?a")))), 4, 2048),
        ("project_drops", plan_of(ir.Distinct(child=ir.Project(
            child=star, schema=("?a", "?b")))), 4, 2048),
        ("distinct_aligned", plan_of(ir.Distinct(child=scan(
            0, ("?x", "?a"), part_col=0)), 1, 0), 4, 2048),
        ("distinct_unknown", plan_of(ir.Distinct(child=scan(
            0, ("?x", "?a"))), 1, 0), 4, 2048),
        ("union_common", plan_of(ir.Distinct(child=ir.UnionAll(
            children=(a, b), schema=("?x", "?v"))), 2, 0), 4, 2048),
        ("union_mixed", plan_of(ir.Distinct(child=ir.UnionAll(
            children=(a, scan(1, ("?x", "?v"))), schema=("?x", "?v"))),
            2, 0), 4, 2048),
        ("sites", plan_of(ir.Distinct(child=chain)), 4, 2048),
        ("cross", plan_of(cross), 4, 2048),
        ("left_join", plan_of(left, 3, 2), 4, 0),
        ("slice", plan_of(sliced), 4, 2048),
    ]
    return out


PLAN_NAMES = [name for name, *_ in _plans(t_ir)]


def _strategies(dx, plan, n_shards, broadcast_rows):
    return [
        (s.op, s.key, s.left, s.right, s.emitted, s.elided, s.broadcast,
         dx.format_strategy(s))
        for s in dx.analyze_plan(plan, n_shards, broadcast_rows)
    ]


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_analyze_plan_equals_reference(name):
    (_, jp, n, br), = [p for p in _plans(j_ir) if p[0] == name]
    (_, tp, _, _), = [p for p in _plans(t_ir) if p[0] == name]
    want = _strategies(j_dx, jp, n, br)
    assert _strategies(t_dx, tp, n, br) == want
    assert t_dx.strategy_counts(t_dx.analyze_plan(tp, n, br)) == (
        j_dx.strategy_counts(j_dx.analyze_plan(jp, n, br))
    )
    assert [type(x).__name__ for x in t_dx.shuffle_site_nodes(tp)] == [
        type(x).__name__ for x in j_dx.shuffle_site_nodes(jp)
    ]
    for sizes in ((4,), (2, 2), (2, 4), 8):
        assert t_dx.initial_shuffle_caps(tp, sizes) == (
            j_dx.initial_shuffle_caps(jp, sizes)
        )
    assert t_dx.n_shuffle_slots(tp, 2) == j_dx.n_shuffle_slots(jp, 2)


def test_partitioning_lattice():
    assert t_dx.UNKNOWN.kind == "unknown"
    assert t_dx.REPLICATED.kind == "replicated"
    assert str(t_dx.hash_part(("?x", "?y"))) == "hash(?x,?y)"
    with pytest.raises(AssertionError):
        t_dx.hash_part(())


# -- the LUBM plans -------------------------------------------------------------


@pytest.fixture(scope="module")
def lubm_stores():
    js = j_lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    terms = [js.dictionary.decode(i) for i in range(len(js.dictionary))]
    return js, TripleStore.from_arrays(js.triples, terms)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("name", list(QUERIES))
def test_optimizer_shard_term_equals_reference(lubm_stores, name, n_shards):
    """Join order, estimates, backends and the trace (with its
    shuffle_cost line past one shard) over the merged statistics."""
    js, ts = lubm_stores
    jss, tss = j_ss.shard_store(js, n_shards), t_ss.shard_store(ts, n_shards)
    want = j_opt.optimize(j_parse(QUERIES[name]), jss, n_shards=n_shards)
    got = t_opt.optimize(t_parse(QUERIES[name]), tss, n_shards=n_shards)
    assert got.trace == want.trace
    assert got.join_ests == want.join_ests
    assert got.join_backends == want.join_backends
    assert [[(p.s, p.p, p.o) for p in g] for g in (
        got.required, *got.opt_groups, *got.branches)] == [
        [(p.s, p.p, p.o) for p in g] for g in (
            want.required, *want.opt_groups, *want.branches)]
    has_cost = any(t.startswith("shuffle_cost[") for t in got.trace)
    assert has_cost == (n_shards > 1 and any(
        len(g) > 1 for g in (got.required, *got.opt_groups, *got.branches)))


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("name", list(QUERIES))
def test_lubm_plan_analysis_equals_reference(lubm_stores, name, n_shards):
    """The sharded engine's own plan for each query (per-shard caps, the
    subject-hash scan parts), analysed by both packages."""
    _, ts = lubm_stores
    eng = ShardedQueryEngine(t_ss.shard_store(ts, n_shards), device="cpu")
    prog = eng._build_program(t_parse(QUERIES[name]))
    _, shape, _ = eng._canonicalize(prog)
    assert any(p >= 0 for p in shape.scan_parts)
    j_shape = j_ir.shape_from_jsonable(t_ir.shape_to_jsonable(shape))
    caps = (64,) * shape.n_joins()
    tp, jp = t_ir.build_plan(shape, caps), j_ir.build_plan(j_shape, caps)
    assert _strategies(t_dx, tp, n_shards, 2048) == _strategies(
        j_dx, jp, n_shards, 2048)
    assert t_dx.initial_shuffle_caps(tp, (n_shards,)) == (
        j_dx.initial_shuffle_caps(jp, (n_shards,)))
    assert t_dx.initial_shuffle_caps(tp, (2, 2)) == (
        j_dx.initial_shuffle_caps(jp, (2, 2)))


# -- the exchanges --------------------------------------------------------------

MESHES = {
    "4": t_dist.make_mesh((4,), ("shards",)),
    "2x2": t_dist.make_mesh((2, 2), ("pod", "data")),
    "2x4": t_dist.make_mesh((2, 4), ("pod", "data")),
}


def _fnv(row) -> int:
    h = 2166136261
    for x in row:
        h = ((h ^ (int(x) & 0xFFFFFFFF)) * 16777619) & 0xFFFFFFFF
    return h


def _sharded_rows(seed, s, n, c, lanes=1, p_valid=0.8):
    rng = np.random.default_rng(seed)
    cols = rng.integers(-40, 40, (lanes * s, n, c)).astype(np.int32)
    cols[..., 0][rng.random((lanes * s, n)) < 0.05] = 2**31 - 1
    valid = rng.random((lanes * s, n)) < p_valid
    return cols, valid


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_shuffle_by_key_equals_numpy(mesh, lanes):
    """Every valid row lands on shard hash(key) % n_shards of its own
    lane, in source-rank order then row order; the needs are each stage's
    exact worst per-destination load and nothing overflows at a cap
    that fits."""
    m = MESHES[mesh]
    s, n, key = m.n_shards, 50, [1, 0]
    cols, valid = _sharded_rows(len(mesh) + lanes, s, n, 3, lanes)
    out_c, out_v, ov, need = t_dist.shuffle_by_key(
        torch.from_numpy(cols), torch.from_numpy(valid), key, m, 64
    )
    assert out_c.shape == (lanes * s, m.axis_sizes[-1] * 64, 3)
    assert not bool(ov.any())
    for lane in range(lanes):
        want = [[] for _ in range(s)]
        for src in range(s):
            b = lane * s + src
            for r in range(n):
                if valid[b, r]:
                    row = cols[b, r]
                    want[_fnv(row[key]) % s].append(tuple(row))
        for dst in range(s):
            b = lane * s + dst
            got = [tuple(r) for r in out_c[b][out_v[b]].numpy()]
            if len(m.axis_sizes) == 1:
                assert got == want[dst]  # source rank, then row order
            else:
                assert sorted(got) == sorted(want[dst])
    # stage needs: the exact worst per-destination load of each stage
    sizes = m.axis_sizes
    for b in range(lanes * s):
        d = np.array([_fnv(r[key]) % s for r in cols[b]])[valid[b]]
        coord0 = (d // int(np.prod(sizes[1:]))) % sizes[0]
        assert int(need[b, 0]) == int(
            np.bincount(coord0, minlength=sizes[0]).max(initial=0))


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_shuffle_overflow_flags_the_stage_and_reports_the_need(mesh):
    m = MESHES[mesh]
    cols, valid = _sharded_rows(9, m.n_shards, 200, 2, p_valid=1.0)
    cols[..., 0] = 7  # one hot key: every row bound for one shard
    _, _, ov, need = t_dist.shuffle_by_key(
        torch.from_numpy(cols), torch.from_numpy(valid), [0], m, 8
    )
    assert bool(ov[:, 0].all())
    assert (need[:, 0] == 200).all()


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_all_gather_and_all_to_all_equal_numpy(mesh, lanes):
    m = MESHES[mesh]
    s = m.n_shards
    rng = np.random.default_rng(lanes)
    x = rng.integers(0, 100, (lanes * s, 5, 2)).astype(np.int32)
    got = t_dist.all_gather(torch.from_numpy(x), m).numpy()
    for lane in range(lanes):
        flat = np.concatenate([x[lane * s + k] for k in range(s)])
        for k in range(s):
            np.testing.assert_array_equal(got[lane * s + k], flat)
    coords = list(np.ndindex(*m.axis_sizes))
    for a, axis in enumerate(m.axis_names):
        size = m.axis_sizes[a]
        buf = rng.integers(0, 100, (lanes * s, size, 3)).astype(np.int32)
        out = t_dist.all_to_all(torch.from_numpy(buf), m, axis).numpy()
        for lane in range(lanes):
            for r, c in enumerate(coords):
                for j in range(size):
                    src = list(c)
                    src[a] = j
                    sr = coords.index(tuple(src))
                    np.testing.assert_array_equal(
                        out[lane * s + r, j], buf[lane * s + sr, c[a]]
                    )


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_distributed_join_equals_the_single_join(mesh):
    m = MESHES[mesh]
    rng = np.random.default_rng(3)
    s, cap = m.n_shards, 32
    left = Relation(("?x", "?y"),
                    torch.from_numpy(rng.integers(0, 20, (s * cap, 2))
                                     .astype(np.int32)),
                    torch.from_numpy(rng.random(s * cap) < 0.7))
    right = Relation(("?y", "?z"),
                     torch.from_numpy(rng.integers(0, 20, (s * cap, 2))
                                      .astype(np.int32)),
                     torch.from_numpy(rng.random(s * cap) < 0.7))
    fn = t_dist.make_distributed_join(m, 64, 256, left.schema, right.schema)
    out, totals, ov = fn(left, right)
    assert not bool(ov.any())
    want, total, _ = t_mj.mr_join(left, right, 4096)
    assert int(totals.sum()) == int(total)
    assert sorted(map(tuple, out.to_numpy())) == sorted(
        map(tuple, want.to_numpy()))
    assert out.schema == want.schema


@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 1000), (4, 0), (2, 3, 5)])
def test_cumsum_i32_equals_torch_and_batches(shape, dtype):
    """The joins' prefix sum: equal to torch's int32 cumsum along the last
    axis, called directly and under vmap, also where the running sum
    wraps past INT32_MAX."""
    from repro_torch.core.segments import cumsum_i32

    gen = torch.Generator().manual_seed(len(shape))
    if dtype == torch.bool:
        x = torch.rand(shape, generator=gen) < 0.5
    else:
        x = torch.randint(-(2**30), 2**30, shape, generator=gen,
                          dtype=torch.int32)
    want = torch.cumsum(x, dim=-1, dtype=torch.int32)
    assert torch.equal(cumsum_i32(x), want)
    if len(shape) >= 2:
        assert torch.equal(torch.func.vmap(cumsum_i32)(x), want)
        moved = x.movedim(0, -1).contiguous()
        assert torch.equal(
            torch.func.vmap(cumsum_i32, in_dims=x.dim() - 1)(moved), want)

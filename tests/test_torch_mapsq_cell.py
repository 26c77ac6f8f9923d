"""The `mapsq` cell's step (the distributed MapReduce join of two
relations, rows cut over every mesh axis) on a (data 2, model 2) mesh of
4 local shards at 2^12 rows a side, with the cell's capacities: shard by
shard, the same output block (cols and valid, in order), total and
overflow flag as the JAX package's `make_distributed_join_fn` on 4 host
devices (Auto axes, in a subprocess); int32 and bool, exactly. The
valid rows of all shards are the NumPy oracle's join as a multiset, and
nothing overflows. The step's kernel (pair_expand) runs its plain
version here."""
import collections
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (test files import both frameworks)
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.core.relation import Relation
from repro_torch.launch.mesh import make_local_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = 1 << 12


def _relations():
    rng = np.random.RandomState(5)
    return (rng.randint(0, ROWS, (ROWS, 2)).astype(np.int32),
            rng.randint(0, ROWS, (ROWS, 2)).astype(np.int32))


@pytest.fixture(scope="module")
def port():
    if "WORLD_SIZE" in os.environ:
        pytest.fail("WORLD_SIZE is set: the local mesh would be ranks")
    mesh = make_local_mesh(data=2, model=2)
    cell = R._build_sparql("mapsq", R.importlib.import_module(
        R.ARCHS["mapsq"]).CONFIG, "join_4k", {"kind": "join", "rows": ROWS},
        mesh, False)
    left, right = _relations()
    out, total, ov = cell.fn(
        Relation(("?x", "?y"), torch.from_numpy(left),
                 torch.ones(ROWS, dtype=torch.bool)),
        Relation(("?y", "?z"), torch.from_numpy(right),
                 torch.ones(ROWS, dtype=torch.bool)))
    return cell, out, total, ov


@pytest.fixture(scope="module")
def reference(tmp_path_factory, port):
    d = tmp_path_factory.mktemp("mapsq")
    left, right = _relations()
    caps = R.join_capacities(ROWS, {"data": 2, "model": 2})
    np.savez(d / "in.npz", left=left, right=right, caps=np.asarray(caps))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_mapsq_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(d / "out.npz"))


def test_join_equals_the_reference_shard_by_shard(port, reference):
    _, out, total, ov = port
    np.testing.assert_array_equal(total.numpy(), reference["total"])
    np.testing.assert_array_equal(ov.numpy(), reference["overflow"])
    np.testing.assert_array_equal(out.valid.numpy(), reference["valid"])
    np.testing.assert_array_equal(out.cols.numpy(), reference["cols"])


def test_join_equals_the_oracle_with_no_overflow(port):
    cell, out, total, ov = port
    assert not ov.any()
    left, right = _relations()
    by_y = collections.defaultdict(list)
    for y, z in right:
        by_y[y].append(z)
    want = collections.Counter((x, y, z) for x, y in left for z in by_y[y])
    rows = out.cols.numpy()[out.valid.numpy()]
    assert collections.Counter(map(tuple, rows.tolist())) == want
    assert int(total.sum()) == sum(want.values())
    assert cell.note == "bucket_cap={} join_cap={}".format(
        *R.join_capacities(ROWS, {"data": 2, "model": 2}))

"""`serve --shards 2` under torch.distributed.run on the CPU: two ranks,
one shard each (gloo), answer every query with the rows of the
one-process `--shards 2` server; and the engine's rank-mode rules."""
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch  # noqa: F401

from repro_torch.core import distributed as t_dist
from repro_torch.sparql import lubm as t_lubm
from repro_torch.sparql.engine import ShardedQueryEngine
from repro_torch.sparql.sharded_store import shard_store

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SERVE = ["-m", "repro_torch.launch.serve", "--mode", "sparql", "--shards",
         "2", "--device", "cpu", "--scale", "1", "--n-queries", "2"]


def _serve(args: list[str], cwd) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, *args], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=240,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _answers(stdout: str) -> dict[str, str]:
    return dict(re.findall(r"^(Q\d#\d): (\d+ rows, sha1 \w+)$", stdout,
                           re.MULTILINE))


def test_serve_under_the_launcher_answers_as_one_process(tmp_path):
    ranks = _serve(["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "2", *SERVE], tmp_path)
    one = _serve(SERVE, tmp_path)
    got, want = _answers(ranks), _answers(one)
    assert len(want) == 2 * len(t_lubm.QUERIES)
    assert got == want
    assert "one per rank, backend gloo" in ranks
    assert "on one device" in one


def test_serve_refuses_shards_other_than_the_ranks(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="one shard per rank"):
        serve.serve_sparql(scale=1, n_queries=1, device="cpu", shards=4)


class _Ranks:
    """A rank context's surface the engine reads, for host-only rules."""

    def __init__(self, rank, mesh, device="cpu"):
        self.rank, self.device = rank, torch.device(device)
        self.mesh = t_dist.make_mesh(mesh.axis_sizes, mesh.axis_names)
        object.__setattr__(self.mesh, "ranks", self)

    def broadcast(self, obj=None):
        raise AssertionError("no call may be sent")


def test_rank_mode_rules_of_the_engine():
    """The store's shard count is the world size; the mesh and device are
    the ranks'; a follower refuses public calls; one process never
    follows."""
    base = t_lubm.generate(scale=1)
    two = t_dist.make_mesh((2,), ("shards",))
    with pytest.raises(ValueError, match="shards"):
        ShardedQueryEngine(shard_store(base, 3), ranks=_Ranks(0, two))
    with pytest.raises(ValueError, match="mesh"):
        ShardedQueryEngine(shard_store(base, 2), ranks=_Ranks(0, two),
                           mesh=t_dist.make_mesh((1, 2), ("pod", "data")))
    with pytest.raises(ValueError, match="device"):
        ShardedQueryEngine(shard_store(base, 2), ranks=_Ranks(0, two),
                           device="cuda:1")
    follower = ShardedQueryEngine(shard_store(base, 2), ranks=_Ranks(1, two))
    assert follower.device == torch.device("cpu")
    assert follower.mesh.local_shards == 1 and follower.mesh == two
    with pytest.raises(RuntimeError, match="follow"):
        follower.query(t_lubm.QUERIES["Q1"])
    with pytest.raises(RuntimeError, match="follow"):
        follower.update(t_lubm.PREFIX + "INSERT DATA { <a> <b> <c> . }")
    alone = ShardedQueryEngine(shard_store(base, 2), device="cpu")
    with pytest.raises(RuntimeError, match="rank other than 0"):
        alone.follow()
    alone.close()  # nothing to end without ranks
    assert alone.query(t_lubm.QUERIES["Q1"])

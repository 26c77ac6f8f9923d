"""Nothing the benchmark runs imports JAX or the JAX package `repro`, the
reference imports nothing of the port, and the command refuses to run
without a card. Top-level module names are compared whole: the port's
`repro_torch` begins with `repro`."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)


def _tops(stdout: str) -> set[str]:
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_neither_jax_nor_repro():
    p = _run(
        "import json, sys\n"
        "from portbench import harness\n"
        "from portbench.catalog import cell_of\n"
        "r = harness.run(cell_of('portbench/configs/lubm100_shard4.json',\n"
        "                        'analytic'), 5, 0.3,\n"
        "                trace=True, device='cpu', scale=1)\n"
        "assert r['correct'], r\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert p.returncode == 0, p.stderr[-3000:]
    tops = _tops(p.stdout)
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    p = _run(
        "import json, sys\n"
        "import portbench.reference, portbench.lubmgen, portbench.mix\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert p.returncode == 0, p.stderr[-3000:]
    tops = _tops(p.stdout)
    assert not tops & (FORBIDDEN | {"repro_torch", "torch"}), tops


def test_forbidden_names_are_compared_whole():
    ported = ["repro_torch", "repro_torch.sparql.engine", "reprox", "jaxtyping"]
    assert harness.forbidden_modules(ported) == []
    assert harness.forbidden_modules(ported + ["repro.sparql"]) == ["repro"]
    assert harness.forbidden_modules(["jax._src", "flax"]) == ["flax", "jax"]


def test_the_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs one without")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_the_benchmark_alone_refuses_to_run(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's folder has
    no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""

"""The PyTorch port stands alone: importing every module of `repro_torch`
loads neither JAX nor any module of the JAX package."""
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (test files import both frameworks)
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list[str]:
    root = SRC / "repro_torch"
    mods = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_reference():
    mods = _port_modules()
    for m in (
        "repro_torch.sparql.engine",
        "repro_torch.kernels.bitonic_sort.ops",
        "repro_torch.kernels.segment_reduce.ops",
        "repro_torch.serve.batcher",
        "repro_torch.serve.decode",
        "repro_torch.serve.sparql_server",
        "repro_torch.launch.serve",
        "repro_torch.obs.metrics",
        "repro_torch.obs.trace",
    ):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_server_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        serve.serve_sparql(scale=1, n_queries=1)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("the server launcher ran without a card")


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine

    store = lubm.generate(scale=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        QueryEngine(store)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("QueryEngine() ran without a card")
    assert QueryEngine(store, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu").type == "cpu"

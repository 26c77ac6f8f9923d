"""Every (arch x shape x mesh) cell of the port's registry equals the
reference's: `build_cell` on the 16 x 16 and 2 x 16 x 16 production
meshes gives, leaf for leaf, the same global shape, dtype and spec as
the JAX package's ShapeDtypeStructs and NamedShardings, the same kind,
and the same model_flops within 1e-12 relative (shapes, dtypes, specs
and kinds exactly).

Both sides run in subprocesses (tests/_torch_cells_dump.py): the
reference on 512 forced host devices, the port on rank 0 of a fake
process group (one group a process), so this process stays free of
both."""
import json
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (test files import both frameworks)
import pytest

from repro_torch.configs.registry import ARCHS, SHAPES_FOR

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s, m) for a in ARCHS for s in SHAPES_FOR(a)
         for m in ("single", "multi")]
FLOPS_RTOL = 1e-12


def _dump(which: str, out: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_cells_dump.py"), which,
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    return _dump("ref", d / "ref.json"), _dump("port", d / "port.json")


def test_every_cell_is_built(dumps):
    ref, port = dumps
    assert len(ref) == 84
    assert set(port) == set(ref)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_inputs_equal_the_reference(dumps, arch, shape, mesh):
    ref, port = dumps
    key = f"{arch}/{shape}/{mesh}"
    want, got = ref[key], port[key]
    assert got["kind"] == want["kind"]
    assert got["model_flops"] == pytest.approx(want["model_flops"],
                                               rel=FLOPS_RTOL)
    assert sorted(got["leaves"]) == sorted(want["leaves"])
    for path, leaf in want["leaves"].items():
        assert got["leaves"][path] == leaf, path

"""Dump every (arch x shape x mesh) cell's inputs as JSON, from the JAX
package's `build_cell` ("ref", on 512 forced host devices) or the port's
("port", on rank 0 of a fake process group of 256, then 512 ranks):

    python tests/_torch_cells_dump.py ref|port OUT.json

Each cell is keyed "arch/shape/single|multi" and holds its kind, its
model_flops and, per input leaf path (the reference's
`jax.tree_util.keystr`), the global shape, the dtype's name and the spec
(each entry a list of axes or null, trailing nulls dropped).
test_torch_cells.py runs both and compares them."""
import json
import os
import re
import sys


def _spec(entries) -> list:
    out = [None if e is None else ([e] if isinstance(e, str) else list(e))
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return out


def _path(key: str) -> str:
    """A keystr with a custom pytree's child index ("[<flat index 0>]",
    a relation's cols) written as a sequence index ("[0]")."""
    return re.sub(r"\[<flat index (\d+)>\]", r"[\1]", key)


def ref() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax

    from repro.configs.registry import ARCHS, SHAPES_FOR, build_cell
    from repro.launch.mesh import make_production_mesh

    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in ARCHS:
            for shape in SHAPES_FOR(arch):
                cell = build_cell(arch, shape, mesh, multi)
                flat, _ = jax.tree_util.tree_flatten_with_path(cell.inputs)
                out[f"{arch}/{shape}/{'multi' if multi else 'single'}"] = {
                    "kind": cell.kind,
                    "model_flops": float(cell.model_flops),
                    "leaves": {
                        _path(jax.tree_util.keystr(path)): [
                            list(x.shape), str(x.dtype),
                            _spec(x.sharding.spec)]
                        for path, x in flat},
                }
    return out


def port() -> dict:
    from repro_torch.configs.registry import (
        ARCHS, SHAPES_FOR, build_cell, input_leaves,
    )
    from repro_torch.launch.mesh import make_production_mesh

    out = {}
    for multi in (False, True):
        ranks = make_production_mesh(multi_pod=multi)
        for arch in ARCHS:
            for shape in SHAPES_FOR(arch):
                cell = build_cell(arch, shape, ranks, multi)
                out[f"{arch}/{shape}/{'multi' if multi else 'single'}"] = {
                    "kind": cell.kind,
                    "model_flops": float(cell.model_flops),
                    "leaves": {
                        path: [list(leaf.shape),
                               str(leaf.dtype).replace("torch.", ""),
                               _spec(leaf.spec)]
                        for path, leaf in input_leaves(cell.inputs).items()},
                }
    return out


if __name__ == "__main__":
    which, path = sys.argv[1], sys.argv[2]
    with open(path, "w") as f:
        json.dump({"ref": ref, "port": port}[which](), f)

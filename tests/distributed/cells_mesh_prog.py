"""The reference's steps in the layouts of its cells (src/repro/configs/
registry.py: `_build_lm`'s train, prefill and decode cells, `_build_gnn`'s
edge-cut cells), on forced host devices with Auto axes, on the inputs of
the port's cell-layout tests, for tests/test_torch_mesh_pod.py and
tests/test_torch_dist_layouts.py to hold the port's rank programs to:

    python tests/distributed/cells_mesh_prog.py pod OUT.npz
    python tests/distributed/cells_mesh_prog.py layouts OUT.npz

The inputs are drawn by tests/_torch_cell_ranks.py, which this program
imports (with tests/ on the path): the same seeded weights, batches,
prompts, caches and graphs the rank programs take, handed to the
reference as numpy. Every input is placed as the reference's cell
places it (params by `param_specs`, the batch over the data axes, the
decode cache on its sequence dim, every edge set over every axis with
the node tables whole); the optimizer state follows the params.

- pod (8 devices, mesh (pod 2, data 2, model 2)): the train step with
  the multi-pod specs on each of `POD_CASES`: the first step's loss and
  grad_norm, under `pod/<case>/`;
- layouts (4 devices, the meshes `LAYOUT_MESHES` over ("data", "model")):
  the prefill step on each of `PREFILL_KINDS` (next tokens and the
  caches, `prefill/<mesh>/<kind>/`), the serve step on each decode case
  whose batch splits over "data" (each step's next tokens and the
  caches after the last, `decode/<mesh>/<kind>/<batch>/`), and one GNN
  train step on each of `GNN_EDGE_CASES` in float32 (grad_norm and the
  params, `gnn/<mesh>/<arch>/`).

The meshes have Auto axes and the calls run under `compat.set_mesh`
(jax 0.9's `make_mesh` defaults to Explicit axes, which the reference's
sharding constraints do not take); the device count locks at JAX's
first use, so each part runs in a process of its own.
"""
import os
import sys

PART = sys.argv[1] if len(sys.argv) > 1 else "pod"
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={8 if PART == 'pod' else 4} "
    + os.environ.get("XLA_FLAGS", "")
)

import dataclasses  # noqa: E402
import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry as RR  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.gnn.common import GraphBatch  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro_torch import tree as TT  # noqa: E402
from repro_torch.data import graphs as TG  # noqa: E402
from repro_torch.launch.train import reduced_gnn  # noqa: E402

import _torch_cell_ranks as CR  # noqa: E402
import _torch_train_ranks as TRR  # noqa: E402


def make_mesh(sizes, names) -> Mesh:
    n = int(np.prod(sizes))
    return Mesh(np.array(jax.devices()[:n]).reshape(sizes), names,
                axis_types=(AxisType.Auto,) * len(sizes))


def ref_lm_config(cfg):
    """The reference's TransformerConfig of a port config (float32)."""
    names = {f.name for f in dataclasses.fields(RT.TransformerConfig)}
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name in names}
    return RT.TransformerConfig(**dict(kw, dtype=jnp.float32))


def ref_opt():
    return RA.AdamWConfig(**dataclasses.asdict(TRR.OPT))


def to_jax(tree):
    """A tree of torch tensors (dicts) as numpy-backed jax arrays."""
    return TT.map(lambda t: jnp.asarray(t.detach().cpu().numpy()), tree)


def place(x, spec, mesh):
    return jax.device_put(x, NamedSharding(mesh, spec))


def place_params(params, specs, mesh):
    return jax.tree.map(lambda s, x: place(x, s, mesh), specs, params,
                        is_leaf=lambda s: isinstance(s, P))


def pod(out: dict) -> None:
    mesh = make_mesh((2, 2, 2), CR.POD_AXES)
    dp = RT.dp_axes(True)
    for case in CR.POD_CASES:
        cfg = TRR.lm_config(*case)
        rcfg = ref_lm_config(cfg)
        model = mesh.shape["model"]
        params = place_params(to_jax(TRR.lm_params(cfg, model)),
                              RT.param_specs(rcfg, True, model), mesh)
        batch = {k: place(jnp.asarray(v), P(dp, None), mesh)
                 for k, v in TRR.lm_batches(cfg, 1)[0].items()}
        step = jax.jit(RT.make_train_step(rcfg, mesh, ref_opt(), True))
        with compat.set_mesh(mesh):
            _, _, m = step(params, RA.adamw_init(params), batch)
        key = "pod/" + "-".join(map(str, case))
        out[f"{key}/loss"] = np.asarray(m["loss"])
        out[f"{key}/grad_norm"] = np.asarray(m["grad_norm"])


def prefill(out: dict, mesh, tag: str) -> None:
    model = mesh.shape["model"]
    for kind in CR.PREFILL_KINDS:
        cfg = CR.layout_config(kind)
        rcfg = ref_lm_config(cfg)
        params = place_params(to_jax(TRR.lm_params(cfg, model)),
                              RT.param_specs(rcfg, False, model), mesh)
        tokens = place(jnp.asarray(CR.prompt_tokens(cfg)), P("data", None),
                       mesh)
        step = jax.jit(RT.make_prefill_step(rcfg, mesh, False))
        with compat.set_mesh(mesh):
            nxt, kc, vc = step(params, tokens)
        for k, v in (("next", nxt), ("kc", kc), ("vc", vc)):
            out[f"prefill/{tag}/{kind}/{k}"] = np.asarray(v)


def decode(out: dict, mesh, tag: str) -> None:
    model, data = mesh.shape["model"], mesh.shape["data"]
    for kind, batch in CR.DECODE_CASES:
        if batch % data:
            continue
        cfg = CR.layout_config(kind)
        rcfg = ref_lm_config(cfg)
        params, kc, vc, feed = CR.decode_inputs(cfg, batch, model)
        params = place_params(to_jax(params),
                              RT.param_specs(rcfg, False, model), mesh)
        if batch > 1:  # registry.py's decode cells
            cspec, tspec = P(None, "data", "model", None, None), P("data")
        else:
            cspec, tspec = P(None, None, ("data", "model"), None, None), P()
        kc = place(jnp.asarray(kc.numpy()), cspec, mesh)
        vc = place(jnp.asarray(vc.numpy()), cspec, mesh)
        step = jax.jit(RT.make_serve_step(rcfg, mesh, False))
        key = f"decode/{tag}/{kind}/{batch}"
        with compat.set_mesh(mesh):
            for i, tok in enumerate(feed):
                nxt, kc, vc = step(params, kc, vc, jnp.int32(CR.P0 + i),
                                   place(jnp.asarray(tok), tspec, mesh))
                out[f"{key}/next{i}"] = np.asarray(nxt)
        out[f"{key}/kc"], out[f"{key}/vc"] = np.asarray(kc), np.asarray(vc)


def gnn(out: dict, mesh, tag: str) -> None:
    axes = tuple(mesh.axis_names)
    edge = set(TG._EDGE_EXTRAS)
    for src, dst, mask, feats in TG._EXTRA_EDGE_SETS.values():
        edge.update((src, dst, mask) + feats)
    for arch, n, e, e_cap, d_feat, _ in CR.GNN_EDGE_CASES:
        _, _, params, g = CR.gnn_edge_case(arch, n, e, e_cap, d_feat,
                                           "float32")
        rcfg = reduced_gnn(arch, importlib.import_module(
            RR.ARCHS[arch]).CONFIG)
        rmod = RR._gnn_module(arch)
        params = place_params(to_jax(params), jax.tree.map(
            lambda _: P(), to_jax(params)), mesh)

        def put(a, is_edge):
            return place(jnp.asarray(a), P(axes) if is_edge else P(), mesh)

        graph = GraphBatch(
            node_feat=put(g.node_feat, False), src=put(g.src, True),
            dst=put(g.dst, True), node_mask=put(g.node_mask, False),
            edge_mask=put(g.edge_mask, True),
            graph_ids=put(g.graph_ids, False),
            extras={k: put(v, k in edge) for k, v in g.extras.items()})

        def step(params, opt_state, graph):
            grads = jax.grad(rmod.loss_fn)(params, graph, rcfg)
            return RA.adamw_update(ref_opt(), grads, opt_state, params)

        with compat.set_mesh(mesh):
            new, _, m = jax.jit(step)(params, RA.adamw_init(params), graph)
        key = f"gnn/{tag}/{arch}"
        out[f"{key}/grad_norm"] = np.asarray(m["grad_norm"])
        for i, leaf in enumerate(jax.tree.leaves(new)):
            out[f"{key}/p{i}"] = np.asarray(leaf)


def main(part: str, dst: str) -> None:
    out: dict = {}
    if part == "pod":
        assert jax.device_count() == 8, jax.devices()
        pod(out)
    else:
        assert jax.device_count() == 4, jax.devices()
        for sizes in CR.LAYOUT_MESHES:
            mesh = make_mesh(sizes, ("data", "model"))
            tag = "x".join(map(str, sizes))
            prefill(out, mesh, tag)
            decode(out, mesh, tag)
            gnn(out, mesh, tag)
    np.savez(dst, **out)
    print("CELLS MESH DONE", part, len(out))


if __name__ == "__main__":
    main(PART, sys.argv[2])

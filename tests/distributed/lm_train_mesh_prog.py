"""The reference's LM train step on a (data 2, model 2) mesh of 4 host
devices, on weights and a batch given from outside: the loss of its
sharded loss function on that mesh and on a one-device mesh (the
sharding invariance of lm_mesh_prog.py), and the loss of one train step
on the mesh, for tests/test_torch_dist_train_lm.py to hold the port's
train step across ranks to.

    python tests/distributed/lm_train_mesh_prog.py IN.npz OUT.npz

IN holds the config's ints and floats under `cfg/<field>`, the params
flattened under `p/<path>` ("blocks/attn/wq"), `tokens` and `labels`
(B, S) int32. OUT holds `mesh_loss`, `mesh_aux`, `one_loss`, `one_aux`
and `step_loss`. The meshes have Auto axes and the calls run under
`compat.set_mesh` (jax 0.9's `make_mesh` defaults to Explicit axes,
which the reference's sharding constraints do not take); the device
count locks at JAX's first use, so this runs in a process of its own.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    + os.environ.get("XLA_FLAGS", "")
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.core import compat  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.optim.adamw import AdamWConfig, adamw_init  # noqa: E402

FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
          "vocab", "n_experts", "top_k", "d_expert_ff", "kv_chunk")


def mesh(data: int, model: int):
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def params_tree(data) -> dict:
    tree: dict = {}
    for key in data.files:
        if not key.startswith("p/"):
            continue
        node = tree
        parts = key[2:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(data[key])
    return tree


def main(src: str, dst: str) -> None:
    assert jax.device_count() == 4, jax.devices()
    data = np.load(src)
    cfg = T.TransformerConfig(
        name="mesh-test", dtype=jnp.float32, remat=True,
        capacity_factor=float(data["cfg/capacity_factor"]),
        **{f: int(data[f"cfg/{f}"]) for f in FIELDS})
    params = params_tree(data)
    tokens = jnp.asarray(data["tokens"])
    labels = jnp.asarray(data["labels"])
    out = {}
    for name, m in (("mesh", mesh(2, 2)), ("one", mesh(1, 1))):
        with compat.set_mesh(m):
            loss, aux = jax.jit(T.make_loss_fn(cfg, m, False))(
                params, tokens, labels)
        out[f"{name}_loss"] = np.asarray(aux["loss"])
        out[f"{name}_aux"] = np.asarray(aux["aux"])
    m = mesh(2, 2)
    step = jax.jit(T.make_train_step(cfg, m, AdamWConfig(), False))
    with compat.set_mesh(m):
        _, _, metrics = step(params, adamw_init(params),
                             {"tokens": tokens, "labels": labels})
    out["step_loss"] = np.asarray(metrics["loss"])
    np.savez(dst, **out)
    print("LM TRAIN MESH DONE", {k: float(v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

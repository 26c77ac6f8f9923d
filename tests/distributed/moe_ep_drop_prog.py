"""The reference's expert-parallel MoE layer (`moe_ffn_ep_local` under
shard_map) on 4 host devices, at capacity factors low enough to drop
assignments: its outputs and each device's drop count, for the port's
tests (tests/test_torch_dist_moe.py) to hold the port's EP across gloo
ranks to.

    python tests/distributed/moe_ep_drop_prog.py IN.npz OUT.npz

IN holds, per case k, `k/router`, `k/we_gate`, `k/we_up`, `k/we_down`,
`k/x` (B, S, D) and `k/cf`, and `meshes` (rows of (data, model)); OUT
holds `k/<data>x<model>/y` and `k/<data>x<model>/dropped` (one count per
device, flat mesh order). The device count locks at JAX's first use, so
this runs in a process of its own. The meshes have Auto axes and the
calls run under `compat.set_mesh`, as the reference needs on jax 0.9.
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
from functools import partial  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import compat  # noqa: E402
from repro.models import moe as M  # noqa: E402


def drops_local(p: M.MoEParams, x, *, st: M.MoESettings, expert_axis: str):
    """The assignments `moe_ffn_ep_local` drops on this device: its two
    route plans, step for step (past chip_cap on the sender, past
    expert_cap on the expert side)."""
    ep = compat.axis_size(expert_axis)
    er = jax.lax.axis_index(expert_axis)
    b, s_loc, d = x.shape
    e_pad = st.e_pad(ep)
    e_local = e_pad // ep
    x_my = x.reshape(b * s_loc, d)
    logits = x_my.astype(jnp.float32) @ p.router.astype(jnp.float32)
    logits = jnp.where(jnp.arange(e_pad) < st.n_experts, logits, -jnp.inf)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), st.top_k)
    a_e = eidx.reshape(-1).astype(jnp.int32)
    n_assign = a_e.shape[0]
    chip_cap = M._round8(int(n_assign / ep * st.capacity_factor) + 8)
    order, slot, ok = M.route_plan(a_e // e_local, jnp.ones((n_assign,), bool),
                                   ep, chip_cap)
    send_e = M.scatter_to_buckets(a_e, order, slot, ok, ep, chip_cap)
    send_v = M.scatter_to_buckets(jnp.ones((n_assign,), jnp.int32), order,
                                  slot, ok, ep, chip_cap)
    recv_e = jax.lax.all_to_all(send_e, expert_axis, 0, 0, tiled=False)
    recv_v = jax.lax.all_to_all(send_v, expert_axis, 0, 0, tiled=False)
    rv = recv_v.reshape(-1) > 0
    expert_cap = M._round8(int(n_assign / e_local * st.capacity_factor) + 8)
    _, _, ok2 = M.route_plan(recv_e.reshape(-1) - er * e_local, rv, e_local,
                             expert_cap)
    n = (n_assign - ok.sum()) + (rv.sum() - ok2.sum())
    return n.astype(jnp.int32)[None]


def run(p, x, st, data, model):
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    pspec = M.MoEParams(router=P(None, None), we_gate=P("model", None, None),
                        we_up=P("model", None, None),
                        we_down=P("model", None, None))
    tok = P(("data",), "model", None)
    with compat.set_mesh(mesh):
        y = jax.jit(compat.shard_map(
            partial(M.moe_ffn_ep_local, st=st, expert_axis="model"),
            mesh=mesh, in_specs=(pspec, tok), out_specs=tok,
            check_vma=False))(p, x)
        dropped = jax.jit(compat.shard_map(
            partial(drops_local, st=st, expert_axis="model"),
            mesh=mesh, in_specs=(pspec, tok), out_specs=P(("data", "model")),
            check_vma=False))(p, x)
    return np.asarray(y), np.asarray(dropped)


def main(src: str, dst: str) -> None:
    assert jax.device_count() == 4, jax.devices()
    data = np.load(src)
    cases = sorted({k.split("/")[0] for k in data.files if "/" in k})
    out = {}
    for k in cases:
        p = M.MoEParams(**{f: jnp.asarray(data[f"{k}/{f}"])
                           for f in M.MoEParams._fields})
        e_pad = p.router.shape[1]
        st = M.MoESettings(n_experts=int(data[f"{k}/n_experts"]),
                           top_k=int(data[f"{k}/top_k"]),
                           d_expert_ff=p.we_gate.shape[-1],
                           capacity_factor=float(data[f"{k}/cf"]))
        assert st.e_pad(4) == st.e_pad(2) == e_pad
        for dm, mm in data["meshes"]:
            y, dropped = run(p, jnp.asarray(data[f"{k}/x"]), st, int(dm),
                             int(mm))
            out[f"{k}/{dm}x{mm}/y"] = y
            out[f"{k}/{dm}x{mm}/dropped"] = dropped
    np.savez(dst, **out)
    print("EP DROP CASES DONE", len(cases))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

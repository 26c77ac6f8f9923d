"""The JAX package's distributed join (`make_distributed_join_fn`) on a
(data 2, model 2) mesh of 4 forced host devices with Auto axes, on the
relations in IN.npz (left, right: (rows, 2) int32; caps: bucket and join
capacity); writes every shard's output block, total and overflow flag to
OUT.npz:

    python tests/_torch_mapsq_ref.py IN.npz OUT.npz
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.core.distributed import make_distributed_join_fn  # noqa: E402
from repro.core.relation import Relation  # noqa: E402


def main(src: str, dst: str) -> None:
    inp = np.load(src)
    bucket_cap, join_cap = (int(x) for x in inp["caps"])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn = make_distributed_join_fn(mesh, ("data", "model"), bucket_cap,
                                  join_cap, ("?x", "?y"), ("?y", "?z"))
    left, right = inp["left"], inp["right"]
    with jax.set_mesh(mesh):
        out, total, ov = jax.jit(fn)(
            Relation(("?x", "?y"), jnp.asarray(left),
                     jnp.ones(left.shape[0], bool)),
            Relation(("?y", "?z"), jnp.asarray(right),
                     jnp.ones(right.shape[0], bool)))
    np.savez(dst, cols=np.asarray(out.cols), valid=np.asarray(out.valid),
             total=np.asarray(total), overflow=np.asarray(ov))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

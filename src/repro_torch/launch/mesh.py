"""Production mesh builders (the reference's `launch/mesh.py`). Functions,
not module constants: importing this module touches no device and no
process group.

    ranks = make_production_mesh(multi_pod=True)  # rank 0 of a fake 512
    mesh = make_local_mesh(data=2, model=2)       # the ranks launched, or
                                                  # 4 local shards
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.core.distributed import ShardMesh, make_mesh
from repro_torch.core.ranks import RankContext, init_ranks


def production_axes(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips multi-pod. "data" is
    batch / shuffle parallel, "model" tensor / expert / sequence
    parallel, "pod" the slow inter-pod axis (data-parallel across pods;
    the hierarchical shuffle routes over it once)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         fake: bool = True) -> RankContext:
    """The rank context of the production mesh. With `fake` this process
    is rank 0 of a `fake` process group of 256 or 512 ranks, its tensors
    on "meta" (the dry-run: a collective there moves nothing and returns
    at once); a fake group of another size that this module made before
    is left first. Without `fake` the launcher started the 256 or 512
    ranks (`init_ranks`), one card each; nothing in the repo runs at that
    size yet, so that branch has no caller."""
    sizes, names = production_axes(multi_pod)
    if not fake:
        return init_ranks(axis_sizes=sizes, axis_names=names)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for s in sizes:
        world *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running: the fake "
                               "production mesh needs a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    device_mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
    return RankContext(0, world, 0, torch.device("meta"), "fake",
                       device_mesh, None)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device=None) -> "RankContext | ShardMesh":
    """A small mesh: under a launcher (WORLD_SIZE set) the ranks it
    started, over ("data", "model") or, with `pod`, ("pod", "data",
    "model") (`init_ranks`; `device` as there); without one, a ShardMesh
    of that shape whose shards all live in this process."""
    sizes = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    if "WORLD_SIZE" in os.environ:
        return init_ranks(device=device, axis_sizes=sizes, axis_names=names)
    return make_mesh(sizes, names)

"""The rank context: the sharded engine with one shard per process.

The reference lays one shard on each device of a `jax.make_mesh` mesh and
moves rows between them with shard_map collectives. PyTorch's idiom is
one process per shard: `init_ranks` joins this process to a
`torch.distributed` process group, sets its device, and builds one
process group per mesh axis with `init_device_mesh`, the counterpart of
`jax.make_mesh`. The `ShardMesh` it returns carries the context, so the
exchanges of `core/distributed.py` run as collectives over those groups.

The backend follows the device: NCCL for a card, gloo for the CPU. gloo
on a card is taken only when the caller asks for it: it is how several
ranks share one card, which NCCL refuses. A separate gloo group on the
CPU carries control messages (the lockstep calls of
`ShardedQueryEngine`). Nothing falls back: a group or a backend that does
not start raises.

    ranks = init_ranks(device="cpu")       # under torch.distributed.run
    store = shard_store(base, ranks.world_size)
    engine = ShardedQueryEngine(store, ranks=ranks)
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import math
import os

import torch
import torch.distributed as dist

from repro_torch.core.distributed import ShardMesh, make_mesh

log = logging.getLogger(__name__)

# how long a collective, or a follower waiting for rank 0's next call,
# may wait before its process group raises (torch's default)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass
class RankContext:
    """This process's place among the ranks, and the groups its
    collectives run over. `mesh` is the ShardMesh whose exchanges cross
    the ranks (flat mesh rank == global rank)."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str
    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    control: object  # a gloo ProcessGroup on the CPU
    mesh: ShardMesh = dataclasses.field(init=False)

    def __post_init__(self):
        names = tuple(self.device_mesh.mesh_dim_names)
        mesh = make_mesh(tuple(self.device_mesh.mesh.shape), names)
        object.__setattr__(mesh, "ranks", self)
        self.mesh = mesh
        self._subgroups = _subset_groups(self.rank, mesh)

    def group(self, axis: "str | tuple[str, ...]"):
        """The process group of this rank's line along mesh axis `axis`:
        its ranks in order of their coordinate on that axis. A tuple of
        axes, in the mesh's order, is the line over those axes, its
        ranks in their flat row-major order (the reference's
        `_flat_rank` over those axes, this rank's index there
        `axis_index(axis)`): every axis is the world group, one axis that
        axis, and any other subset a group built with the context."""
        names = tuple(self.device_mesh.mesh_dim_names)
        if isinstance(axis, tuple):
            if axis == names:
                return dist.group.WORLD
            if len(axis) == 1:
                return self.device_mesh.get_group(axis[0])
            if axis not in self._subgroups:
                raise ValueError(f"a group over {axis}: axes of {names}, "
                                 "in the mesh's order")
            return self._subgroups[axis]
        return self.device_mesh.get_group(axis)

    def axis_size(self, axis: "str | tuple[str, ...]") -> int:
        """Ranks along `axis` (a tuple: the product over its axes)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        return math.prod(self.mesh.axis_size(a) for a in axes)

    def axis_index(self, axis: "str | tuple[str, ...]") -> int:
        """This rank's coordinate along `axis`; over a tuple of axes, its
        flat (row-major) index, its rank in `group(axis)`."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        index = 0
        for a in axes:
            index = (index * self.mesh.axis_size(a)
                     + self.device_mesh.get_local_rank(a))
        return index

    def remesh(self, axis_sizes, axis_names) -> "RankContext":
        """The same ranks over another mesh (its groups built now, by every
        rank together): one launch can run several layouts. The
        context `init_ranks` returned stays the one to `close`."""
        from torch.distributed.device_mesh import init_device_mesh

        sizes = tuple(map(int, axis_sizes))
        if math.prod(sizes) != self.world_size:
            raise ValueError(f"mesh {sizes} does not hold the "
                             f"{self.world_size} ranks")
        kind = "cpu" if self.device.type == "meta" else self.device.type
        mesh = init_device_mesh(kind, sizes, mesh_dim_names=tuple(axis_names))
        return RankContext(self.rank, self.world_size, self.local_rank,
                           self.device, self.backend, mesh, self.control)

    def broadcast(self, obj=None):
        """Rank 0's `obj` on every rank, over the control group (pickled;
        only this program's own ranks send)."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def close(self) -> None:
        """Leave every process group this context joined, once every rank
        is done with them, and drop the references to them: a group
        whose threads outlive the interpreter's shutdown aborts it."""
        dist.barrier(group=self.control)
        dist.destroy_process_group()
        self.device_mesh = self.control = None  # later use raises


def _subset_groups(rank: int, mesh: ShardMesh) -> dict:
    """This rank's group over every subset of two or more of the mesh's
    axes but all of them, keyed by the subset in the mesh's order. The
    multi-pod train cells use each of a ("pod", "data", "model") mesh's
    three: ("pod", "data") cuts the batch (`transformer.dp_axes(True)`),
    ("data", "model") carries `specs.sq_norm`'s sum over the leaves cut
    on both, and ("pod", "model") `specs.reduce_grads`' sum over the
    replicas of a leaf cut on "data" alone (qwen2.5-32b's FSDP leaves at
    train_4k). Every rank creates every line of every subset, in the
    same order, as `new_group` needs; each line lists its ranks in their
    flat order over the subset's axes."""
    names, sizes = mesh.axis_names, mesh.axis_sizes
    coords = list(itertools.product(*(range(s) for s in sizes)))
    out: dict = {}
    for k in range(2, len(names)):
        for axes in itertools.combinations(range(len(names)), k):
            lines: dict = {}
            for flat, c in enumerate(coords):  # row-major: flat order
                rest = tuple(c[i] for i in range(len(names)) if i not in axes)
                lines.setdefault(rest, []).append(flat)
            for members in lines.values():
                group = dist.new_group(ranks=members)
                if rank in members:
                    out[tuple(names[i] for i in axes)] = group
    return out


def backend_for(device: torch.device, backend: "str | None") -> str:
    """NCCL for a card and gloo for the CPU, unless the caller names the
    backend; gloo on a card only when named (ranks sharing one card)."""
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo' (got {backend!r})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device (got {device})")
    return backend


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(
            f"{name} is not set: start the ranks with a launcher "
            "(python -m torch.distributed.run) or set RANK, WORLD_SIZE "
            "and LOCAL_RANK"
        )
    return int(value)


def init_ranks(
    device: "str | torch.device | None" = None,
    backend: "str | None" = None,
    axis_sizes: "tuple[int, ...] | None" = None,
    axis_names: tuple[str, ...] = ("shards",),
    init_method: str = "env://",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> RankContext:
    """Join the ranks the launcher started and build the mesh's groups.

    RANK, WORLD_SIZE and LOCAL_RANK come from the environment; the
    rendezvous is `init_method` (env:// reads MASTER_ADDR and
    MASTER_PORT; a file:// path needs no port). `device` defaults to
    cuda:LOCAL_RANK; `axis_sizes` to one axis of every rank, whose
    product must be the world size."""
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK")
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "ranks on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        # set before the mesh, which would otherwise pick cuda:LOCAL_RANK
        torch.cuda.set_device(dev)
    chosen = backend_for(dev, backend)
    sizes = (world,) if axis_sizes is None else tuple(map(int, axis_sizes))
    if len(sizes) != len(axis_names) or math.prod(sizes) != world:
        raise ValueError(
            f"mesh {sizes} over axes {axis_names} does not hold the "
            f"{world} ranks"
        )
    dist.init_process_group(
        chosen, init_method=init_method, rank=rank, world_size=world,
        timeout=timeout,
    )
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(dev.type, sizes, mesh_dim_names=axis_names)
    control = dist.new_group(backend="gloo", timeout=timeout)
    log.info("rank %d of %d on %s: backend %s, mesh %s over %s", rank,
             world, dev, chosen, sizes, axis_names)
    return RankContext(rank, world, local_rank, dev, chosen, device_mesh,
                       control)

"""Distributed MapSQ: the MapReduce shuffle as exchanges between shards.

The paper's Map phase redistributes (key, value) pairs so equal keys meet:
a hash-partition + all-to-all exchange, then each shard runs the local
sort-merge ReduceDuplicate. A mesh of several axes uses a hierarchical
shuffle, one stage per axis (route along the outer axis first, then the
inner), so traffic over the outer axis happens exactly once.

A process holds its shards along an explicit leading shard axis: a
sharded tensor is (lanes * local_shards, rows, ...), shards in flat
row-major rank order over the mesh axes (lanes = 1 outside a stacked
batch). Two placements, chosen by the caller:

  * one process, every shard on its one device (a plain `make_mesh`):
    local_shards = n_shards, and an exchange is a reshape and transpose
    along that axis;
  * one shard per process (`core/ranks.py`, the reference's one shard
    per device): local_shards = 1, and an exchange is a
    `torch.distributed` collective over the mesh axis's process group.

The exchanges are `all_to_all` and `all_gather` below (with
`gather_shards`, `gather_relation` and `own_shards`, which only the
second placement makes collectives of); everything else is per-shard
work the callers run under `torch.func.vmap` over the axis, so each
kernel call launches once for all of a process's shards. No collective
runs inside a vmap.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import TYPE_CHECKING, ClassVar

import torch
import torch.distributed as dist

from repro_torch.core import mr_join as mj
from repro_torch.core.relation import Relation

if TYPE_CHECKING:
    from repro_torch.core.ranks import RankContext

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """Named mesh axes over the shards, outermost first (row-major): the
    shard at coordinates (c_0, ..., c_{m-1}) has flat rank
    sum_k c_k * prod(axis_sizes[k+1:])."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    # the process groups when each shard is a process of its own
    # (ranks.init_ranks binds them); None when every shard lives on this
    # process's device. A class-level default, not a field: equality and
    # hashing see the axes alone.
    ranks: ClassVar["RankContext | None"] = None

    def __post_init__(self):
        assert len(self.axis_sizes) == len(self.axis_names) >= 1
        assert all(s >= 1 for s in self.axis_sizes), self.axis_sizes

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_shards(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    @property
    def local_shards(self) -> int:
        """Shards this process holds: every one, or its own rank's."""
        return self.n_shards if self.ranks is None else 1


def make_mesh(axis_sizes, axis_names) -> ShardMesh:
    return ShardMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))


# -- differentiable collectives over one process group ------------------------
#
# The model code's exchanges (expert parallelism, the row-sharded lookup,
# the GNN node shuffle) run these between ranks, and their gradients
# through them. Every rank's loss counts once in the total, so the
# backward of an exchange is the same exchange reversed, of an all-gather
# a reduce-scatter (sum), and of an all-reduce (sum) an all-reduce.


@contextlib.contextmanager
def _host_staged(x: torch.Tensor, group):
    """gloo moves a CUDA tensor through host memory and waits for the copy,
    a host sync that sync debugging would refuse: it is allowed for the
    collective alone. NCCL and CPU tensors run as they are."""
    mode = torch.cuda.get_sync_debug_mode() if x.is_cuda else 0
    if not mode or dist.get_backend(group) != "gloo":
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _all_to_all(x: torch.Tensor, group, in_splits, out_splits) -> torch.Tensor:
    """One `all_to_all_single` of the rows of `x`: even chunks of
    x.shape[0] / group size without splits, else `in_splits[j]` rows to
    rank j and `out_splits[j]` rows back from it (host ints)."""
    n = x.shape[0] if out_splits is None else int(sum(out_splits))
    src = x.contiguous()
    out = src.new_empty((n,) + tuple(src.shape[1:]))
    with _host_staged(src, group):
        dist.all_to_all_single(out, src, out_splits, in_splits, group=group)
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.group, ctx.splits = group, (in_splits, out_splits)
        return _all_to_all(x, group, in_splits, out_splits)

    @staticmethod
    def backward(ctx, grad):
        in_splits, out_splits = ctx.splits
        back = _all_to_all(grad, ctx.group, out_splits, in_splits)
        return back, None, None, None


def exchange(x: torch.Tensor, group, in_splits=None, out_splits=None):
    """All-to-all of the rows of `x` over `group`, with a gradient: rank
    j gets chunk j (even chunks, or `in_splits[j]` rows) and the result
    holds, in rank order, what every rank sent here (`out_splits[j]`
    rows from rank j). Splits are host ints; bool rides as uint8."""
    if x.dtype == torch.bool:
        return exchange(x.view(torch.uint8), group, in_splits,
                        out_splits).view(torch.bool)
    return _Exchange.apply(x, group, in_splits, out_splits)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order."""
    src = x.contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    with _host_staged(src, group):
        dist.all_gather_into_tensor(out, src, group=group)
    return out


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad, ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows on every rank, (n, ...) -> (size * n, ...) in
    rank order; the backward is the reduce-scatter (sum) of the gradient,
    each rank's use of the rows counted."""
    return _GatherSum.apply(x, group)


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(size * n, ...) -> (n, ...): rank j gets the sum over ranks of
    their chunk j. An exchange and a sum, so the backward is the
    all-gather of the gradient."""
    size = dist.get_world_size(group)
    got = exchange(x, group)
    return got.reshape((size, x.shape[0] // size) + tuple(x.shape[1:])).sum(0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        with _host_staged(out, group):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x`, on every rank (a copy; `x` is left
    as it is). The backward all-reduces the gradient."""
    return _AllReduceSum.apply(x, group)


# The replicated pair: a tensor every rank of the group holds alike, cut
# into its ranks' slices and put back together. Their backwards take the
# loss downstream of the pair to be the same on every rank (each rank's
# gradient of the replicated tensor is the whole gradient, not a part):
# the gather's backward is then the slice this rank's input made, and the
# split's the all-gather of the slices' gradients. Code whose replicated
# tensors carry parts of their gradient (every rank's loss counting once
# in the total, as the collectives above take it) narrows the tensor to
# its slice and gathers with `all_gather_rows` instead: the narrow's
# backward zero-pads, the gather's reduce-scatters.


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {x.shape[dim]} does not split "
                             f"over {size} ranks")
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        whole = _gather_rows(grad.movedim(ctx.dim, 0), ctx.group)
        return whole.movedim(0, ctx.dim), None, None


def split_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of `x`, a tensor that is the same on
    every rank of `group` (rank j gets the j-th of size even slices). The
    backward all-gathers the slices' gradients: every rank gets the
    gradient of the whole `x`."""
    return _SplitReplicated.apply(x, group, dim)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather_rows(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, rank * ctx.n, ctx.n).clone(), None, None


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order, for an
    output that every rank then uses alike (the MoE block's slices of a
    replicated sequence). The backward is the slice of the gradient that
    this rank's `x` made."""
    return _GatherReplicated.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over `group` of every rank's `x` (a copy, with
    no gradient: a logsumexp's shift)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    with _host_staged(out, group):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# -- the exchanges ------------------------------------------------------------


def all_to_all(buf: torch.Tensor, mesh: ShardMesh, axis: str) -> torch.Tensor:
    """Swap source and destination along one mesh axis: `buf` is
    (lanes * local_shards, size, ...), slot j of each shard bound for the
    shard whose coordinate on `axis` is j (the others equal); the result
    holds in slot j what that shard sent here. Equal to
    `jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)` on every shard."""
    if mesh.ranks is not None:
        # destination-major, so chunk j goes to the axis group's rank j
        # (its coordinate j), and chunk j back holds what rank j sent
        send = buf.transpose(0, 1)
        return exchange(send, mesh.ranks.group(axis)).transpose(0, 1)
    k = mesh.axis_names.index(axis)
    m = len(mesh.axis_sizes)
    lanes = buf.shape[0] // mesh.n_shards
    x = buf.reshape(lanes, *mesh.axis_sizes, *buf.shape[1:])
    return x.transpose(1 + k, 1 + m).reshape(buf.shape)


def all_gather(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """Every shard's rows on every shard: (lanes * local_shards, n, ...)
    -> (lanes * local_shards, n_shards * n, ...), concatenated in flat
    rank order (the reference gathers the innermost axis first)."""
    s = mesh.n_shards
    if mesh.ranks is not None:
        # over the world group, whose rank order is the flat mesh order;
        # bool rides as uint8 (a view), which every backend exchanges
        src = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = _gather_rows(src, None)
        out = out.view(x.dtype) if x.dtype == torch.bool else out
        g = out.reshape(s, x.shape[0], *x.shape[1:]).transpose(0, 1)
        return g.reshape(x.shape[0], s * x.shape[1], *x.shape[2:])
    lanes = x.shape[0] // s
    g = x.reshape(lanes, 1, s * x.shape[1], *x.shape[2:])
    return g.expand(lanes, s, *g.shape[2:]).reshape(lanes * s, *g.shape[2:])


def gather_shards(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """Every shard's block on this process, in flat rank order:
    (lanes * local_shards, n, ...) -> (lanes, n_shards * n, ...). One
    process holds them already (a reshape); across ranks an all_gather."""
    if mesh.ranks is not None:
        return all_gather(x, mesh)
    lanes = x.shape[0] // mesh.n_shards
    return x.reshape(lanes, mesh.n_shards * x.shape[1], *x.shape[2:])


def gather_relation(rel: Relation, mesh: ShardMesh) -> Relation:
    """A per-shard relation (lanes * local_shards, cap, c) -> (lanes,
    n_shards * cap, c), rows in flat rank order on every process. Across
    ranks `valid` rides as one more int32 column: one exchange."""
    if mesh.ranks is None:
        return Relation(rel.schema, gather_shards(rel.cols, mesh),
                        gather_shards(rel.valid, mesh))
    packed = torch.cat(
        [rel.cols, rel.valid[..., None].to(rel.cols.dtype)], -1
    )
    g = gather_shards(packed, mesh)
    return Relation(rel.schema, g[..., :-1], g[..., -1].bool())


def own_shards(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """The inverse selection: (lanes, n_shards, ...) -> (lanes *
    local_shards, ...), the entries of the shards this process holds."""
    if mesh.ranks is not None:
        return x[:, mesh.ranks.rank]
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


# -- the hash and the buckets ---------------------------------------------------


def _hash_cols(cols: torch.Tensor, key_idx) -> torch.Tensor:
    """FNV-1a over columns `key_idx` of (..., n, c) int32 rows -> (..., n)
    int64 holding the uint32 hash: each id is read as uint32 (two's
    complement for negatives) and every product is masked to 32 bits,
    so the result equals the reference's uint32 arithmetic."""
    h = torch.full(cols.shape[:-1], _FNV_OFFSET, dtype=torch.int64,
                   device=cols.device)
    for c in key_idx:
        x = cols[..., c].to(torch.int64) & _U32
        h = ((h ^ x) * _FNV_PRIME) & _U32
    return h


def hash_keys(key_cols: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the key tuple -> uint32 values in int64 (tuple-equal =>
    hash-equal); (..., n, k) int32 -> (..., n)."""
    return _hash_cols(key_cols, range(key_cols.shape[-1]))


def bucketize(cols: torch.Tensor, valid: torch.Tensor, part: torch.Tensor,
              num_parts: int, bucket_capacity: int):
    """Pack rows into per-destination buckets (static shapes).

    `cols` is (n, c) or a batch (b, n, c) with `valid`, `part` (b, n).
    Returns (buf (..., P, cap, c), bvalid (..., P, cap), overflowed (...),
    max_load (...)). Rows beyond a destination's capacity are dropped and
    flagged; rows keep their order within a bucket; `max_load` is the
    EXACT largest per-destination row count (valid rows only, before the
    capacity clamp), so an overflowed shuffle bucket can be regrown to the
    needed size in one step. Dropped rows are written to one spare row
    past the buckets, which is sliced off.
    """
    single = cols.dim() == 2
    if single:
        cols, valid, part = cols[None], valid[None], part[None]
    b, n, c = cols.shape
    dev = cols.device
    part = torch.where(valid, part.to(torch.int32), num_parts)
    order = torch.sort(part, dim=1, stable=True).indices
    part_s = part.gather(1, order)
    cols_s = cols.gather(1, order[..., None].expand(b, n, c))
    valid_s = valid.gather(1, order)
    probes = torch.arange(num_parts + 1, dtype=torch.int32, device=dev)
    offsets = torch.searchsorted(
        part_s, probes.expand(b, num_parts + 1).contiguous(), out_int32=True
    )
    start = offsets.gather(1, part_s.clamp(0, num_parts - 1).long())
    pos = torch.arange(n, dtype=torch.int32, device=dev) - start
    real = (part_s < num_parts) & valid_s
    ok = real & (pos < bucket_capacity)
    spare = num_parts * bucket_capacity
    slot = torch.where(ok, part_s.long() * bucket_capacity + pos, spare)
    buf = cols.new_zeros((b, spare + 1, c)).scatter(
        1, slot[..., None].expand(b, n, c), cols_s.masked_fill(~ok[..., None], 0)
    )
    bvalid = valid.new_zeros((b, spare + 1)).scatter(1, slot, ok)
    overflowed = (real & (pos >= bucket_capacity)).any(dim=1)
    max_load = (offsets[:, 1:] - offsets[:, :-1]).amax(dim=1)
    out = (
        buf[:, :spare].reshape(b, num_parts, bucket_capacity, c),
        bvalid[:, :spare].reshape(b, num_parts, bucket_capacity),
        overflowed,
        max_load,
    )
    return tuple(x[0] for x in out) if single else out


def _shuffle_one_axis(cols, valid, dest_along_axis, mesh: ShardMesh,
                      axis: str, bucket_capacity: int):
    """Route rows to `dest_along_axis` coordinates over one mesh axis."""
    size = mesh.axis_size(axis)
    buf, bvalid, overflowed, max_load = bucketize(
        cols, valid, dest_along_axis, size, bucket_capacity
    )
    # valid rides as one more int32 column: one exchange per stage
    packed = all_to_all(
        torch.cat([buf, bvalid[..., None].to(buf.dtype)], -1), mesh, axis
    )
    b, n_cols = cols.shape[0], cols.shape[-1]
    packed = packed.reshape(b, size * bucket_capacity, n_cols + 1)
    return (
        packed[..., :n_cols].contiguous(),
        packed[..., n_cols].bool(),
        overflowed,
        max_load,
    )


def shuffle_by_key(cols: torch.Tensor, valid: torch.Tensor,
                   key_idx: list[int], mesh: ShardMesh,
                   bucket_capacity: "int | tuple[int, ...]"):
    """Hierarchical MapReduce shuffle: equal keys land on the same shard.

    `cols` is (lanes * local_shards, n, c). The destination shard is
    hash(key) % n_shards; stage k routes along mesh axis k (outermost
    first) by the destination's coordinate on that axis, so traffic over
    the outer axis happens exactly once. `key_idx` names the key COLUMNS
    of `cols`: the destination is recomputed from the payload at each
    stage instead of shipping a key copy.

    `bucket_capacity` is PER STAGE (an int applies to every stage): stage
    k's per-destination load is ~rows/size_k, so the outer stage of a
    hierarchical mesh may need a larger bucket than the inner one.

    Returns (cols, valid, overflowed, need): `overflowed` and `need` are
    (lanes * local_shards, n_stages) — stage k's drop flag and each shard's
    exact worst per-destination load at stage k — so an overflow regrows
    ONLY the overflowing stage's bucket.
    """
    sizes = mesh.axis_sizes
    total = mesh.n_shards
    caps = (
        (int(bucket_capacity),) * len(sizes)
        if isinstance(bucket_capacity, int)
        else tuple(bucket_capacity)
    )
    assert len(caps) == len(sizes), (caps, mesh.axis_names)
    overflow: list[torch.Tensor] = []
    need: list[torch.Tensor] = []
    for k, axis in enumerate(mesh.axis_names):
        dest = _hash_cols(cols, key_idx) % total
        inner = math.prod(sizes[k + 1:])
        coord = (dest // inner) % sizes[k]
        cols, valid, ov, max_load = _shuffle_one_axis(
            cols, valid, coord, mesh, axis, caps[k]
        )
        overflow.append(ov)
        need.append(max_load.to(torch.int32))
    return cols, valid, torch.stack(overflow, 1), torch.stack(need, 1)


class ShuffleSlots:
    """Shuffle staging: issue a shuffle AHEAD of the join that consumes it.

    The distributed lowering walks the plan twice: a prestage pass calls
    `issue()` for every join input that (a) needs a shuffle and (b) is
    produced by a collective-free subtree (scans/filters/projections), then
    the join chain calls `take()` at each consuming site. With every shard
    on one device this changes only the order the work is enqueued in; it
    keeps the reference's shuffle-slot order and accounting.
    """

    def __init__(self):
        self._slots: dict = {}

    def issue(self, slot, cols, valid, key_idx, mesh, caps) -> None:
        assert slot not in self._slots, slot
        self._slots[slot] = shuffle_by_key(cols, valid, key_idx, mesh, caps)

    def ready(self, slot) -> bool:
        return slot in self._slots

    def take(self, slot):
        """(cols, valid, overflowed, need) of a previously issued shuffle."""
        return self._slots.pop(slot)


def distributed_mr_join(
    left: Relation,
    right: Relation,
    mesh: ShardMesh,
    bucket_capacity: int,
    join_capacity: int,
):
    """Shuffle both sides by join key, then local Algorithm 1 per shard.

    Both relations are sharded, (lanes * local_shards, cap, c): each shard
    holds an arbitrary horizontal slice of both and ends holding the join
    results for its hash range. Returns (Relation, local_total,
    overflowed-any-stage), each with the leading shard axis.
    """
    key_vars = mj.shared_vars(left, right)
    if not key_vars:
        raise ValueError("distributed cross join not supported")
    l_idx = [left.schema.index(v) for v in key_vars]
    r_idx = [right.schema.index(v) for v in key_vars]
    l_cols, l_valid, ov_l, _ = shuffle_by_key(left.cols, left.valid, l_idx,
                                              mesh, bucket_capacity)
    r_cols, r_valid, ov_r, _ = shuffle_by_key(right.cols, right.valid, r_idx,
                                              mesh, bucket_capacity)
    l_rel = Relation(left.schema, l_cols, l_valid)
    r_rel = Relation(right.schema, r_cols, r_valid)
    out, total, ov_j = torch.func.vmap(
        lambda l, r: mj.mr_join(l, r, join_capacity)
    )(l_rel, r_rel)
    return out, total, ov_l.any(1) | ov_r.any(1) | ov_j


def make_distributed_join(mesh: ShardMesh, bucket_capacity: int,
                          join_capacity: int,
                          left_schema: tuple[str, ...],
                          right_schema: tuple[str, ...]):
    """A join of two flat row-sharded relations ((local_shards * cap, c),
    row block k on this process's shard k: every block in one process,
    a rank's own block across ranks) -> (flat result, per-shard totals,
    per-shard overflow flags) of the same shards. The shuffle routes
    over every axis of `mesh`; `make_distributed_join_fn` is the same
    join under the reference's name and signature."""
    s = mesh.local_shards

    def shard(rel: Relation, schema) -> Relation:
        assert tuple(rel.schema) == tuple(schema), (rel.schema, schema)
        return Relation(
            rel.schema,
            rel.cols.reshape(s, -1, rel.n_cols),
            rel.valid.reshape(s, -1),
        )

    def fn(left: Relation, right: Relation):
        out, total, ov = distributed_mr_join(
            shard(left, left_schema), shard(right, right_schema), mesh,
            bucket_capacity, join_capacity,
        )
        flat = Relation(
            out.schema, out.cols.reshape(-1, out.n_cols), out.valid.reshape(-1)
        )
        return flat, total, ov

    return fn


def make_distributed_join_fn(mesh, axis_names: tuple[str, ...],
                             bucket_capacity: int, join_capacity: int,
                             left_schema: tuple[str, ...],
                             right_schema: tuple[str, ...]):
    """The reference's `make_distributed_join_fn`: a join of two relations
    whose rows are cut over the mesh axes `axis_names` (every axis of the
    mesh, in its order), `make_distributed_join`'s function. `mesh` is a
    rank context or its ShardMesh (each rank holds its own row block,
    and the totals and flags are this rank's one entry), or a ShardMesh
    of this process alone (every block here, one entry a shard)."""
    shards = getattr(mesh, "mesh", mesh)
    if tuple(axis_names) != tuple(shards.axis_names):
        raise ValueError(f"rows cut over {tuple(axis_names)}: the port cuts "
                         f"them over every axis of {shards.axis_names}")
    return make_distributed_join(shards, bucket_capacity, join_capacity,
                                 left_schema, right_schema)

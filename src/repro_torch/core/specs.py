"""Partition specs over a rank context's mesh: which dims of a tensor are
cut over which mesh axes, the port's form of the reference's
`PartitionSpec`s.

A spec is a tuple with one entry per dim (missing trailing entries are
None): None (the dim is whole on every rank), an axis name, or a tuple
of axis names, outermost first (the dim is cut over their flat index).
A tensor cut by a spec is a plain local tensor on each rank: the
contiguous block of every cut dim that the rank's coordinates pick. The
mesh axes a spec does not name hold the tensor alike (its replicas).

A spec tree has the structure of a parameter tree, a spec where the
parameter tree has a tensor; it is walked along the parameter tree
(`spec_leaves`), since a spec is a tuple and a tuple is also a node.

The collectives are `core.distributed`'s: `gather(..., grad=True)` is
the all-gather whose backward reduce-scatters (sums) the gradient back
to the block, as FSDP's weights need; `reduce_grads` sums a gradient
over the replica axes of its leaf; `sq_norm` counts each distinct
element once.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch
import torch.distributed as dist

from repro_torch import tree as TT
from repro_torch.core import distributed as D

if TYPE_CHECKING:
    from repro_torch.core.ranks import RankContext


def entry_axes(entry) -> tuple[str, ...]:
    """The axes one spec entry cuts its dim over (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def norm(spec: tuple, ndim: int) -> tuple:
    """`spec` padded with None to `ndim` entries."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def axes_of(spec: tuple) -> tuple[str, ...]:
    """Every axis that `spec` cuts on, in order of first use."""
    out: list[str] = []
    for e in spec:
        out += [a for a in entry_axes(e) if a not in out]
    return tuple(out)


def _mesh_axes(ranks: "RankContext", axes) -> tuple[str, ...]:
    """`axes` as the mesh's own: in the mesh's order, those it has."""
    names = tuple(ranks.mesh.axis_names)
    return tuple(a for a in names if a in axes)


def _cuts(spec: tuple, ndim: int, ranks: "RankContext"):
    """(dim, axes, size, index) of every dim `spec` cuts over more than
    one rank of this mesh."""
    out = []
    names = tuple(ranks.mesh.axis_names)
    for dim, e in enumerate(norm(spec, ndim)):
        axes = tuple(a for a in entry_axes(e) if a in names)
        if axes and ranks.axis_size(axes) > 1:
            out.append((dim, axes, ranks.axis_size(axes),
                        ranks.axis_index(axes)))
    return out


def local_shape(shape, spec: tuple, ranks: "RankContext") -> tuple:
    """The block's shape of a tensor of whole `shape` cut by `spec`."""
    out = list(shape)
    for dim, axes, size, _ in _cuts(spec, len(out), ranks):
        if out[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {size} ranks of {axes}")
        out[dim] //= size
    return tuple(out)


def whole_shape(shape, spec: tuple, ranks: "RankContext") -> tuple:
    """The whole shape of a block of `shape` cut by `spec`."""
    out = list(shape)
    for dim, _, size, _ in _cuts(spec, len(out), ranks):
        out[dim] *= size
    return tuple(out)


def shard(whole: torch.Tensor, spec: tuple, ranks: "RankContext"):
    """This rank's block of `whole` (a copy; `whole` itself when the
    spec cuts nothing on this mesh)."""
    cuts = _cuts(spec, whole.dim(), ranks)
    if not cuts:
        return whole
    x = whole
    for dim, axes, size, index in cuts:
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(whole.shape)} does not "
                             f"split over {size} ranks of {axes}")
        n = x.shape[dim] // size
        x = x.narrow(dim, index * n, n)
    return x.clone()


def gather_dim(x: torch.Tensor, group, dim: int, grad: bool = False):
    """Every rank's `x` of `group` concatenated along `dim`, rank order;
    with `grad` the backward reduce-scatters (sums) the gradient."""
    moved = x.movedim(dim, 0)
    whole = D.all_gather_rows(moved, group) if grad else D._gather_rows(
        moved, group)
    return whole.movedim(0, dim)


def gather(local: torch.Tensor, spec: tuple, ranks: "RankContext",
           grad: bool = False) -> torch.Tensor:
    """The whole tensor from every rank's block (cut by `spec`), on every
    rank. With `grad` the gathers carry the gradient back to the blocks
    (summed over the ranks that used the whole)."""
    x = local
    for dim, axes, _, _ in _cuts(spec, local.dim(), ranks):
        x = gather_dim(x, ranks.group(axes), dim, grad)
    return x


def replica_axes(spec: tuple, ranks: "RankContext") -> tuple[str, ...]:
    """The mesh axes of more than one rank that hold a tensor cut by
    `spec` alike, in the mesh's order."""
    used = axes_of(spec)
    return tuple(a for a in ranks.mesh.axis_names
                 if a not in used and ranks.axis_size(a) > 1)


def spec_leaves(specs, tree) -> list:
    """The spec of every leaf of `tree`, in `tree.leaves` order: `specs`
    has `tree`'s structure with a spec for each tensor."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(specs[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for i, t in enumerate(tree)
                for s in spec_leaves(specs[i], t)]
    return [tuple(specs)]


def map_leaves(fn, tree, specs):
    """`fn(leaf, spec)` over the leaves of `tree`, in `tree`'s structure."""
    return TT.unflatten(tree, [fn(x, s) for x, s in zip(
        TT.leaves(tree), spec_leaves(specs, tree))])


def shard_tree(tree, specs, ranks: "RankContext"):
    """Every leaf of a whole tree as this rank's block."""
    return map_leaves(lambda x, s: shard(x, s, ranks), tree, specs)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group` in place (no gradient)."""
    with D._host_staged(x, group):
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def reduce_grads(grads, specs, ranks: "RankContext"):
    """Each leaf's gradient summed over its replica axes (the ranks that
    hold the leaf alike each hold a part of its gradient)."""
    def one(g, spec):
        axes = replica_axes(spec, ranks)
        if not axes:
            return g
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                            ranks.group(_mesh_axes(ranks, axes)))

    return map_leaves(one, grads, specs)


@torch.no_grad()
def sq_norm(tree, specs, ranks: "RankContext") -> torch.Tensor:
    """The float32 sum of squares of every distinct element of a tree of
    blocks: each leaf's local sum, summed over the ranks of the axes it
    is cut on (a leaf whole on an axis counts once there). One all-reduce
    per distinct set of axes."""
    parts: dict[tuple, Any] = {}
    for x, spec in zip(TT.leaves(tree), spec_leaves(specs, tree)):
        axes = tuple(a for a in _mesh_axes(ranks, axes_of(spec))
                     if ranks.axis_size(a) > 1)
        s = torch.sum(x.to(torch.float32) ** 2)
        parts[axes] = s if axes not in parts else parts[axes] + s
    total = None
    for axes in sorted(parts):
        s = parts[axes].reshape(1)
        if axes:
            s = all_reduce_(s.clone(), ranks.group(axes))
        total = s if total is None else total + s
    return total.reshape(())


# -- ZeRO-1 ---------------------------------------------------------------------


def zero1_spec(spec: tuple, shape, data_size: int) -> tuple:
    """Add a ZeRO-1 "data" cut on the first free dim of the whole `shape`
    that the data size divides (the reference's `registry.zero1_spec`)."""
    dims = list(norm(spec, len(shape)))
    if "data" in dims or ("data",) in dims:
        return tuple(dims)
    for i, (d, s) in enumerate(zip(dims, shape)):
        if d is None and s % data_size == 0 and s >= data_size:
            dims[i] = "data"
            break
    return tuple(dims)


def opt_specs(param_specs_tree, param_shapes_tree, data_size: int) -> dict:
    """The AdamW state's specs (the reference's `registry._opt_specs`): m
    and v cut as their params and, by ZeRO-1, over "data"; the step
    whole. `param_shapes_tree` holds the whole params (tensors on any
    device: "meta" gives the shapes alone)."""
    mv = map_leaves(lambda x, spec: zero1_spec(spec, x.shape, data_size),
                    param_shapes_tree, param_specs_tree)
    return {"m": mv, "v": mv, "step": ()}

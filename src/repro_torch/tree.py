"""Parameter trees: nested dicts, lists and tuples of tensors, in the leaf
order of `jax.tree.flatten` (dict keys sorted at every level, sequences in
order), so that a flat list of leaves lines up with the reference's: the
optimizer's norm sums leaves in that order and a checkpoint stores them
in it. `grad` is `jax.grad` over such a tree."""
from __future__ import annotations

from typing import Any, Callable

import torch


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def leaves(tree) -> list:
    """The leaves of `tree` in `jax.tree.leaves` order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in leaves(k)]


def paths(tree, prefix: str = "") -> list[str]:
    """One name per leaf ("blocks/attn/wq", "layers[0]/w"), in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}[{i}]")]
    return [prefix]


def unflatten(like, flat: list):
    """A tree of `like`'s structure whose leaves are `flat`, in leaf order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # the caller's key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (jax.tree.map's name)
    """`fn` over matching leaves of trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def grad(fn: Callable, params, *args, has_aux: bool = True):
    """The gradient of `fn(params, *args)` with respect to every leaf of
    `params`, as `jax.grad(fn, has_aux=has_aux)`: `fn` returns a scalar,
    or (scalar, aux) with `has_aux`; returns grads, or (grads, aux) with
    aux detached. A leaf the loss does not reach gets a zero gradient, as
    in JAX. The caller's tensors are not changed (the graph is built on
    detached views of them)."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        out = fn(unflatten(params, live), *args)
        gs = torch.autograd.grad(out[0] if has_aux else out, live,
                                 allow_unused=True)
    gs = unflatten(params, [torch.zeros_like(p) if g is None else g
                            for p, g in zip(flat, gs)])
    if not has_aux:
        return gs
    return gs, map(lambda a: a.detach(), out[1])

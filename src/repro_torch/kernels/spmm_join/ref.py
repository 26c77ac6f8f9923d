"""Plain PyTorch versions of the matrix join's layout reductions.

Both are dense compares, evaluated in left-row blocks so that one block's
compare tile stays under TILE_ELEMS elements whatever the input sizes.
`match_layout` carries the running column sums of the equality tile from
one block to the next, the formulation of the jnp reference; the CUDA
kernel computes the same sums by an identity instead (see its source).
"""
from __future__ import annotations

import torch

TILE_ELEMS = 1 << 22


def _rows_per_block(n_cols: int) -> int:
    return max(1, TILE_ELEMS // max(n_cols, 1))


def match_layout(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """Everything the gather expansion needs, from dense eq/lt compares:

      counts[i] = |{j : rk[j] == lk[i]}|
      first[i]  = |{j : rk[j] <  lk[i]}|
      b[i]      = sum_j [rk[j] == lk[i]] * |{i' < i : lk[i'] == rk[j]}|
      cl[j]     = |{i : lk[i] == rk[j]}|
    """
    n_l, n_r = left_keys.shape[0], right_keys.shape[0]
    rk = right_keys[None, :]
    carry = torch.zeros(n_r, dtype=torch.int32, device=right_keys.device)
    parts = []
    step = _rows_per_block(n_r)
    for base in range(0, n_l, step):
        blk = left_keys[base:base + step, None]
        eq = (blk == rk).to(torch.int32)
        cume = torch.cumsum(eq, dim=0, dtype=torch.int32) - eq + carry
        parts.append((
            eq.sum(dim=1, dtype=torch.int32),
            (rk < blk).sum(dim=1, dtype=torch.int32),
            (eq * cume).sum(dim=1, dtype=torch.int32),
        ))
        carry = carry + eq.sum(dim=0, dtype=torch.int32)
    counts, first, b = (torch.cat(p) for p in zip(*parts))
    return counts, first, b, carry


def match_layout_sorted(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """match_layout's outputs from sorted sides and searches, the identities
    of the CUDA kernel's sort-and-search path: the oracle for shapes where
    the dense compares are too many (tests and chip_smoke.py call it; no
    op does). With lk_sorted, rk_sorted the stably sorted keys and p[i] the
    sorted position of left row i:

      first[i]  = lower_bound(rk_sorted, lk[i])
      counts[i] = upper_bound(rk_sorted, lk[i]) - first[i]
      b[i]      = counts[i] * (p[i] - lower_bound(lk_sorted, lk[i]))
      cl[j]     = upper_bound(lk_sorted, rk[j]) - lower_bound(lk_sorted, rk[j])

    b wraps mod 2^32 as the dense version's int32 sum does. Takes (n,)
    keys or stacks of lanes (lanes, n).
    """
    left_keys, right_keys = left_keys.contiguous(), right_keys.contiguous()
    lk_sorted, order = torch.sort(left_keys, dim=-1, stable=True)
    rk_sorted = torch.sort(right_keys, dim=-1).values
    pos = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order).contiguous())
    first = torch.searchsorted(rk_sorted, left_keys)
    counts = torch.searchsorted(rk_sorted, left_keys, right=True) - first
    occ = pos - torch.searchsorted(lk_sorted, left_keys)
    b = (counts * occ + 2**31) % 2**32 - 2**31  # int64 products, wrapped
    cl = (torch.searchsorted(lk_sorted, right_keys, right=True)
          - torch.searchsorted(lk_sorted, right_keys))
    return tuple(x.to(torch.int32) for x in (counts, first, b, cl))


def sort_ranks(keys: torch.Tensor) -> torch.Tensor:
    """rank[j] = |{j' : keys[j'] < keys[j]}| + |{j' < j : keys[j'] == keys[j]}|
    — each row's stable sorted position (a permutation of 0..n-1)."""
    n = keys.shape[0]
    j_all = torch.arange(n, device=keys.device)
    parts = []
    step = _rows_per_block(n)
    for base in range(0, n, step):
        blk = keys[base:base + step, None]
        j = j_all[base:base + step, None]
        before = j_all[None, :] < j
        less = keys[None, :] < blk
        same = keys[None, :] == blk
        parts.append((less | (same & before)).sum(dim=1, dtype=torch.int32))
    return torch.cat(parts)

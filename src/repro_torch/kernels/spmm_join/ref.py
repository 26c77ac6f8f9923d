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

"""Transformer building blocks: RMSNorm, RoPE, GQA attention (chunked
online-softmax for long prefill), SwiGLU FFN.

Plain functions on tensors. Per-layer weights arrive WITHOUT the layer
axis (the caller indexes the stacked weights), and attention takes an
`is_global` flag so local/global layer patterns (gemma3's 5:1) share one
code path. The dtypes follow `repro.models.layers`: scores, softmax and
the attention accumulator in float32, the cast back to the activation
dtype before `wo`, and `rms_norm` in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh), positions: (..., S)."""
    d_half = x.shape[-1] // 2
    freq = float(theta) ** (
        -torch.arange(0, d_half, dtype=torch.float32, device=x.device) / d_half
    )
    ang = positions[..., :, None].float() * freq  # (..., S, d_half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :d_half], x[..., d_half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnParams(NamedTuple):
    wq: torch.Tensor  # (D, H*Dh)
    wk: torch.Tensor  # (D, K*Dh)
    wv: torch.Tensor  # (D, K*Dh)
    wo: torch.Tensor  # (H*Dh, D)
    bq: torch.Tensor | None = None  # (H*Dh,) — qwen-style QKV bias
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None


def _project_qkv(p: AttnParams, x: torch.Tensor, n_heads: int, n_kv: int,
                 d_head: int):
    b, s, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (
        q.reshape(b, s, n_heads, d_head),
        k.reshape(b, s, n_kv, d_head),
        v.reshape(b, s, n_kv, d_head),
    )


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """GQA scores without materializing repeated KV.

    q: (B, Sq, H, Dh) grouped as (B, Sq, K, G, Dh); k: (B, Sk, K, Dh).
    Returns (B, K, G, Sq, Sk) float32 (the products of the inputs, summed
    in float32).
    """
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, sq, kheads, g, dh)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())


def _grouped_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, K, G, Sq, Sk), v: (B, Sk, K, Dh) -> (B, Sq, H, Dh)."""
    b, kheads, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, kheads * g, v.shape[-1])


def kv_chunk_len(s: int, kv_chunk: int) -> int:
    """The key chunk of a prompt of `s` tokens: min(kv_chunk, s). A prompt
    longer than one chunk must be a whole number of chunks: the reference
    reshapes the keys into chunks and fails on any other length, and so
    does this (it raises rather than drop keys)."""
    if s > kv_chunk and s % kv_chunk:
        raise ValueError(
            f"prompt length {s} is neither <= kv_chunk {kv_chunk} nor a "
            "multiple of it"
        )
    return min(kv_chunk, s)


def online_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   kv_chunk: int, is_global: bool, window: int,
                   q_offset: int = 0) -> torch.Tensor:
    """Causal attention over KV chunks with a running (max, sum, out), the
    flash-attention recurrence: never materializes the full (Sq, Sk) score
    matrix. q (already scaled): (B, Sq, H, Dh), the queries of positions
    q_offset .. q_offset + Sq - 1; k, v: (B, Sk, K, Dh), the keys of
    positions 0 .. Sk - 1 (Sq = Sk and no offset: self-attention over
    the whole sequence). Local layers (`is_global` false) add a
    sliding-window mask of width `window`. Returns (B, Sq, H*Dh)
    float32."""
    b, s, h, dh = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    q_idx = q_offset + torch.arange(s, dtype=torch.int32, device=q.device)
    m = torch.full((b, n_kv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, g, s), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, n_kv, g, s, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, k.shape[1], kv_chunk):
        kc = k[:, c0:c0 + kv_chunk]
        vc = v[:, c0:c0 + kv_chunk]
        sc_ = _grouped_scores(q, kc)  # (B, K, G, Sq, C)
        k_idx = c0 + torch.arange(kv_chunk, dtype=torch.int32, device=q.device)
        mask = q_idx[:, None] >= k_idx[None, :]
        if not is_global:
            mask = mask & ((q_idx[:, None] - k_idx[None, :]) < window)
        sc_ = torch.where(mask, sc_, NEG_INF)
        m_new = torch.maximum(m, sc_.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(sc_ - m_new[..., None])
        l = l * alpha + pr.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", pr, vc.float()
        )
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h * dh)


def attention_prefill(
    p: AttnParams,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope_theta: float,
    is_global: bool,
    window: int,
    kv_chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal self-attention, chunked over KV (online softmax). The prompt
    is a whole number of `kv_chunk` chunks, as in the reference."""
    b, s, _ = x.shape
    if s % kv_chunk:
        raise ValueError(f"prompt length {s} is not a multiple of kv_chunk "
                         f"{kv_chunk}")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, d_head)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    sc = scale if scale is not None else d_head**-0.5
    o = online_softmax(q * sc, k, v, kv_chunk=kv_chunk, is_global=is_global,
                       window=window)
    return o.to(x.dtype) @ p.wo


def decode_core(q, k_new, v_new, k_cache, v_cache, pos: int, *, scale: float,
                is_global: bool, window: int) -> torch.Tensor:
    """Write the new token's K/V (B, 1, K, Dh) into the caches (B, S_max,
    K, Dh) IN PLACE at `pos`, then attend q (B, 1, H, Dh) over every key
    written so far (on local layers, within the window). Returns
    (B, 1, H*Dh) float32."""
    b, _, h, dh = q.shape
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    scores = _grouped_scores(q * scale, k_cache)  # (B, K, G, 1, S_max)
    k_idx = torch.arange(k_cache.shape[1], dtype=torch.int32, device=q.device)
    mask = k_idx <= pos
    if not is_global:
        mask = mask & ((pos - k_idx) < window)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    return _grouped_values(probs, v_cache).reshape(b, 1, h * dh)


def attention_decode(
    p: AttnParams,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: int,
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope_theta: float,
    is_global: bool,
    window: int,
    scale: float | None = None,
):
    """One-token decode against a KV cache.

    x: (B, 1, D); caches: (B, S_max, K, Dh), written IN PLACE at
    `cache_len` (a host int: the write position of the new token).
    Returns (attn_out (B, 1, D), k_cache, v_cache).
    """
    pos = int(cache_len)
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv, d_head)
    posv = torch.arange(pos, pos + 1, dtype=torch.int32, device=x.device)[None, :]
    q = rope(q, posv, rope_theta)
    k_new = rope(k_new, posv, rope_theta)
    o = decode_core(q, k_new, v_new, k_cache, v_cache, pos,
                    scale=scale if scale is not None else d_head**-0.5,
                    is_global=is_global, window=window)
    return o.to(x.dtype) @ p.wo, k_cache, v_cache


class FFNParams(NamedTuple):
    w_gate: torch.Tensor  # (D, F)
    w_up: torch.Tensor  # (D, F)
    w_down: torch.Tensor  # (F, D)


def swiglu_ffn(p: FFNParams, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


def dense_init(gen: torch.Generator | None, shape, fan_in: int, dtype,
               device=None) -> torch.Tensor:
    """A scaled normal, drawn in float32 from `gen` (on its device, or on
    `device` when `gen` is None) and cast to `dtype`."""
    dev = gen.device if gen is not None else device
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            * fan_in**-0.5).to(dtype)

"""Mixture-of-Experts FFN with MapSQ-style sort-based expert dispatch.

The MoE token→expert exchange IS the paper's MapReduce join:

  Map    — every (token, expert-choice) assignment is tagged with its
           destination (expert owner), the paper's key tagging;
  Sort   — assignments are sorted stably by destination (``route_plan``);
  Shuffle— the rows move to their owners' buckets (an ``all_to_all`` over
           the expert ranks; the identity at one expert shard);
  Reduce — on the expert side a second sort groups rows into contiguous
           per-expert segments for the grouped GEMM; the weighted combine
           back on the token side is the segment-sum reduce.

Two realizations, one logical join, as in `repro.models.moe`:
  * ``moe_ffn_ep_local`` — the sort-based path for training and prefill:
    each rank of the expert group (a `RankContext` axis, one process per
    expert shard) routes its tokens to the experts' owners through
    `core.distributed.exchange` and back; at one shard (no rank context)
    the exchanges are the identity.
  * ``moe_ffn_onehot`` — a GShard-style one-hot-dispatch einsum used at
    decode time, where token counts are tiny; across ranks each rank
    dispatches to its own experts and the partial outputs are summed.

Expert counts that don't divide the expert axis are padded to the next
multiple; padded experts get -inf router logits and are never selected.
Top-k takes the k largest router probabilities with the lower expert index
first among equal ones (`lax.top_k`'s order), from a stable descending
sort.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as D
from repro_torch.core.segments import segment_offsets_from_sorted

if TYPE_CHECKING:
    from repro_torch.core.ranks import RankContext


class MoEParams(NamedTuple):
    router: torch.Tensor  # (D, E_pad)
    we_gate: torch.Tensor  # (E_pad, D, Fe)
    we_up: torch.Tensor  # (E_pad, D, Fe)
    we_down: torch.Tensor  # (E_pad, Fe, D)


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_expert_ff: int
    capacity_factor: float = 2.0

    def e_pad(self, ep: int) -> int:
        return ((self.n_experts + ep - 1) // ep) * ep


# ---------------------------------------------------------------------------
# Routing machinery (the Map + Sort phases)
# ---------------------------------------------------------------------------

def route_plan(part: torch.Tensor, valid: torch.Tensor, num_parts: int, cap: int):
    """Sort rows by destination partition and assign buffer slots.

    Returns (order, slot, ok):
      order — permutation sorting rows by destination (stable);
      slot  — flat index into a (num_parts, cap) buffer, for sorted row j;
      ok    — sorted-row validity (dest in range, within capacity).
    """
    n = part.shape[0]
    part = torch.where(valid, part, num_parts).to(torch.int32)
    order = torch.sort(part, stable=True).indices
    part_s = part[order]
    offsets = segment_offsets_from_sorted(part_s, num_parts)
    pos = (torch.arange(n, dtype=torch.int32, device=part.device)
           - offsets[part_s.clamp(0, num_parts - 1).long()])
    ok = (part_s < num_parts) & (pos < cap)
    slot = torch.where(ok, part_s * cap + pos, num_parts * cap)
    return order, slot, ok


def _row_mask(ok: torch.Tensor, ndim: int) -> torch.Tensor:
    return ok.reshape((-1,) + (1,) * (ndim - 1))


def scatter_to_buckets(data, order, slot, ok, num_parts: int, cap: int):
    """Pack rows (in original order) into a (num_parts, cap, ...) buffer.
    Rows not `ok` go to one spare row past the buffer, which is dropped."""
    trail = data.shape[1:]
    src = data[order].masked_fill(~_row_mask(ok, data.ndim), 0)
    buf = torch.zeros((num_parts * cap + 1,) + trail, dtype=data.dtype,
                      device=data.device)
    buf[slot.long()] = src
    return buf[: num_parts * cap].reshape((num_parts, cap) + trail)


def gather_from_buckets(buf, order, slot, ok, n_rows: int):
    """Inverse of scatter_to_buckets: recover per-row values (original order).
    Rows that were dropped (not ok) come back as zeros."""
    flat = buf.reshape((-1,) + buf.shape[2:])
    res_sorted = flat[slot.clamp(0, flat.shape[0] - 1).long()]
    res_sorted = res_sorted.masked_fill(~_row_mask(ok, flat.ndim), 0)
    out = torch.zeros((n_rows,) + flat.shape[1:], dtype=flat.dtype,
                      device=flat.device)
    out[order] = res_sorted
    return out


def _router_probs(p: MoEParams, xf: torch.Tensor, st: MoESettings, e_pad: int):
    logits = xf.float() @ p.router.float()
    live = torch.arange(e_pad, device=xf.device) < st.n_experts
    logits = torch.where(live, logits, float("-inf"))
    return torch.softmax(logits, dim=-1)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (as `lax.top_k`)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) indicator of `idx`; an index outside [0, n) gives a row of
    zeros (as `jax.nn.one_hot`, where `F.one_hot` raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _expert_swiglu(p: MoEParams, xe: torch.Tensor, dtype) -> torch.Tensor:
    """Grouped SwiGLU over per-expert buffers xe (E, C, D); products summed
    in float32, the hidden cast to `dtype` and the output float32."""
    g = torch.einsum("ecd,edf->ecf", xe.float(), p.we_gate.float())
    u = torch.einsum("ecd,edf->ecf", xe.float(), p.we_up.float())
    h = (F.silu(g) * u).to(dtype)
    return torch.einsum("ecf,efd->ecd", h.float(), p.we_down.float())


# ---------------------------------------------------------------------------
# Sort-based expert path (prefill): the two shuffles over the expert group
# ---------------------------------------------------------------------------

def expert_group(ranks: "RankContext | None", axis: str):
    """(ep, this rank's coordinate, process group) of the expert axis; one
    shard (1, 0, None) without a rank context."""
    if ranks is None:
        return 1, 0, None
    return ranks.axis_size(axis), ranks.axis_index(axis), ranks.group(axis)


def moe_ffn_ep_local(p: MoEParams, x: torch.Tensor, st: MoESettings, *,
                     ranks: "RankContext | None" = None,
                     expert_axis: str = "model",
                     count_dropped: bool = False):
    """The expert-parallel MoE layer on this rank (the reference's
    shard_map body).

    x: (B, S_loc, D) — this rank's tokens; p: this rank's experts
    (we_*: (e_local, ...)), the router (D, e_pad) whole. `ranks` gives
    the expert group along `expert_axis` (ep ranks); without it the layer
    runs at one shard (ep = 1) and the two shuffles are the identity.
    Assignments past a destination rank's `chip_cap` or an expert's
    `expert_cap` are dropped, the same ones as the reference drops: the
    route order is stable per rank and the expert side sorts received
    rows stably in (source rank, slot) order. With `count_dropped` the
    layer returns (y, n): n is their number on this rank (sender and
    expert side), a 0-d int64 tensor on x's device (no host sync).
    """
    ep, er, group = expert_group(ranks, expert_axis)
    b, s_loc, d = x.shape
    t_my = b * s_loc
    e_pad = p.router.shape[-1]
    e_local = e_pad // ep
    if p.we_gate.shape[0] * ep != e_pad:
        raise ValueError(
            f"{p.we_gate.shape[0]} experts on each of {ep} expert shard(s) "
            f"for a router over {e_pad}: pass the ranks whose shard they are")
    k = st.top_k
    dev = x.device

    x_my = x.reshape(t_my, d)
    # Router (Map phase: key = expert id).
    probs = _router_probs(p, x_my, st, e_pad)
    gate_vals, eidx = top_k(probs, k)  # (t_my, k)

    a_e = eidx.reshape(-1).to(torch.int32)  # (A,) assignment expert ids
    a_tok = (torch.arange(t_my, dtype=torch.int32, device=dev)[:, None]
             .expand(t_my, k).reshape(-1))  # each token k times
    a_gate = gate_vals.reshape(-1)
    n_assign = a_e.shape[0]

    # Sort + bucketize by destination rank, shuffle (all_to_all).
    chip_cap = _round8(int(n_assign / ep * st.capacity_factor) + 8)
    dest = torch.div(a_e, e_local, rounding_mode="floor")
    every = torch.ones((n_assign,), dtype=torch.bool, device=dev)
    order, slot, ok = route_plan(dest, every, ep, chip_cap)
    send_x = scatter_to_buckets(x_my[a_tok.long()], order, slot, ok, ep,
                                chip_cap)
    # expert id and valid flag ride together: one int32 exchange
    send_meta = scatter_to_buckets(
        torch.stack([a_e, torch.ones_like(a_e)], dim=1),
        order, slot, ok, ep, chip_cap,
    )
    recv_x, recv_meta = send_x, send_meta
    if group is not None:
        recv_x = D.exchange(send_x.reshape(ep * chip_cap, d), group)
        recv_meta = D.exchange(send_meta.reshape(ep * chip_cap, 2), group)

    # Expert-side Reduce: second sort groups rows into per-expert segments.
    n_recv = ep * chip_cap
    rx = recv_x.reshape(n_recv, d)
    re_loc = recv_meta[..., 0].reshape(-1) - er * e_local
    rv = recv_meta[..., 1].reshape(-1) > 0
    expert_cap = _round8(int(n_assign / e_local * st.capacity_factor) + 8)
    order2, slot2, ok2 = route_plan(re_loc, rv, e_local, expert_cap)
    ebuf = scatter_to_buckets(rx, order2, slot2, ok2, e_local, expert_cap)

    # Grouped GEMM over contiguous expert segments (SwiGLU experts).
    eout = _expert_swiglu(p, ebuf, x.dtype).to(x.dtype)

    # Return trip: un-bucket on the expert side, shuffle back, un-bucket at
    # the sender, weighted segment-sum combine over each token's k slots
    # (a_tok repeats each token k times, so its slots are one contiguous
    # segment).
    res_recv = gather_from_buckets(eout, order2, slot2, ok2, n_recv)
    back = res_recv
    if group is not None:
        back = D.exchange(res_recv, group)
    back = back.reshape(ep, chip_cap, d)
    res_asn = gather_from_buckets(back, order, slot, ok, n_assign)
    combined = (res_asn.float() * a_gate[:, None]).reshape(t_my, k, d).sum(dim=1)
    y = combined.to(x.dtype).reshape(b, s_loc, d)
    if count_dropped:
        return y, (n_assign - ok.sum()) + (rv.sum() - ok2.sum())
    return y


def _round8(n: int) -> int:
    return ((n + 7) // 8) * 8


# ---------------------------------------------------------------------------
# One-hot dispatch path (decode: tiny token counts)
# ---------------------------------------------------------------------------

def moe_ffn_onehot(p: MoEParams, x: torch.Tensor, st: MoESettings, e_pad: int,
                   capacity: int | None = None, *,
                   ranks: "RankContext | None" = None,
                   expert_axis: str = "model") -> torch.Tensor:
    """GShard-style dispatch/combine einsum MoE for small T (decode).

    x: (B, S, D) with B*S small. The (T, E, C) dispatch tensor is the dense
    materialization of the same token↔expert join; it is only affordable
    because T is tiny at decode time. Assignments past an expert's
    `capacity`, counted over the flattened (T·k) order, are dropped.

    With `ranks`, x is the same on every rank of the expert group and p
    holds this rank's experts: each rank dispatches to its own expert
    columns only (an expert's slots are a running count over its own
    column, so they do not depend on the other ranks' experts), and the
    partial outputs are summed over the group (an all-reduce) before the
    cast to x's type.
    """
    b, s, d = x.shape
    t = b * s
    k = st.top_k
    cap = capacity or _round8(max(k, int(t * k / st.n_experts * 4) + 1))
    xf = x.reshape(t, d)
    probs = _router_probs(p, xf, st, e_pad)
    gate_vals, eidx = top_k(probs, k)  # (T, k)
    onehot = one_hot(eidx, e_pad, torch.int32)  # (T, k, E)
    # position of each assignment within its expert (running count over T*k)
    flat = onehot.reshape(t * k, e_pad)
    pos = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat).reshape(t, k, e_pad)
    ep, er, group = expert_group(ranks, expert_axis)
    e_local = e_pad // ep
    mine = slice(er * e_local, (er + 1) * e_local)
    onehot, pos = onehot[..., mine], pos[..., mine]
    within = pos < cap
    disp = (onehot * within).to(x.dtype)  # (T, k, E_local)
    # dispatch tensor (T, E, C): 1 where token t goes to expert e slot c
    posc = torch.sum(pos * onehot, dim=-1)  # (T, k) slot per assignment
    slot_1h = one_hot(posc, cap, x.dtype)  # (T, k, C); 0 past the capacity
    dmask = torch.einsum("tke,tkc->tec", disp, slot_1h)
    xe = torch.einsum("tec,td->ecd", dmask, xf)  # (E, C, D)
    eo = _expert_swiglu(p, xe, x.dtype)
    comb = torch.einsum("tke,tkc->tec", disp * gate_vals[..., None].to(x.dtype),
                        slot_1h).float()
    y = torch.einsum("tec,ecd->td", comb, eo)
    if group is not None:
        y = D.all_reduce_sum(y, group)
    return y.to(x.dtype).reshape(b, s, d)


def moe_aux_loss(p: MoEParams, x: torch.Tensor, st: MoESettings,
                 e_pad: int) -> torch.Tensor:
    """Switch-style load-balance loss (one (T, E) router matmul)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = _router_probs(p, xf, st, e_pad)
    _, eidx = top_k(probs, st.top_k)
    f = torch.mean(one_hot(eidx, e_pad, torch.float32).sum(dim=1), dim=0)
    pmean = torch.mean(probs, dim=0)
    return st.n_experts * torch.sum(f * pmean) / st.top_k


def init_moe_params(gen: torch.Generator | None, d_model: int, st: MoESettings,
                    ep: int, dtype, device=None) -> MoEParams:
    """Router (float32) and SwiGLU experts, drawn from `gen` in the order
    router, gate, up, down; padded experts are zero."""
    e_pad = st.e_pad(ep)
    fe = st.d_expert_ff
    dev = gen.device if gen is not None else device
    live = (torch.arange(e_pad, device=dev) < st.n_experts).float()

    def draw(shape, fan_in):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev) * fan_in**-0.5

    def w(shape, fan_in):
        return (draw(shape, fan_in) * live[:, None, None]).to(dtype)

    router = draw((d_model, e_pad), d_model)
    return MoEParams(
        router=router,
        we_gate=w((e_pad, d_model, fe), d_model),
        we_up=w((e_pad, d_model, fe), d_model),
        we_down=w((e_pad, fe, d_model), fe),
    )

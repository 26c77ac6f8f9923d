"""LM transformer family: one config covers the five LM archs
(olmoe-1b-7b, granite-moe-3b-a800m, qwen2.5-32b, gemma3-1b, deepseek-67b).

Structure, as in `repro.models.transformer`: weights are stacked per layer
(a leading layer axis on every block leaf) and the layer stack is a loop
over per-layer views of them (one `unbind` per leaf and call, so a
backward stacks each leaf's gradient once); attention is chunked
online-softmax (never materializes S×S); MoE layers use the MapSQ
sort-based dispatch (models/moe.py) at train / prefill and the one-hot
einsum at decode, their experts sharded over the ranks of a
`RankContext`'s "model" axis when one is passed (expert parallelism:
`init_params(ranks=)` or `shard_params`, then `ranks=` to the forward and
the serving steps). With `cfg.remat` a training forward rematerializes
each block in the backward (`torch.utils.checkpoint`, as the reference's
`jax.checkpoint` of the scanned block).

Training: `ce_loss` / `chunked_ce_loss`, `make_loss_fn` and
`make_train_step` (gradients by `torch.autograd.grad` over the param
leaves, optional micro-batch accumulation in float32, then AdamW), on one
device: the train step across ranks is not ported yet.

Serving: `make_prefill_step` runs the prompt once and exports the post-RoPE
K/V of every layer; `make_serve_step` decodes one token per sequence
against a static (L, B, S_max, K, Dh) cache, written in place. Positions
are host ints, so a decode loop makes no host sync.

`params_from_numpy` carries the reference's params (as numpy arrays)
across, leaf by leaf, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as TT
from repro_torch.core import distributed as D
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update

if TYPE_CHECKING:
    from repro_torch.core.ranks import RankContext

# the mesh axis the experts shard over (the reference's "model" axis)
EXPERT_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    capacity_factor: float = 2.0
    # attention pattern
    sliding_window: int = 0  # 0 -> full attention in every layer
    global_every: int = 0  # gemma3: every Nth layer global (5:1 -> 6)
    qkv_bias: bool = False  # qwen
    qk_norm: bool = False  # gemma3
    rope_theta: float = 1e4
    rope_theta_local: float = 0.0  # gemma3 local layers (0 -> same)
    embed_scale: bool = False  # gemma: x *= sqrt(d_model)
    tied_embeddings: bool = False
    # distribution: kept so the arch configs copy over unchanged; one
    # device reads none of them (no mesh, and the layer loop is plain
    # Python, so there is no scan to unroll)
    fsdp: bool = False
    seq_shard: bool = True
    remat: bool = True  # rematerialize each block in a training backward
    dtype: Any = torch.bfloat16
    kv_chunk: int = 1024
    scan_unroll: bool = False
    # fuse head projection + CE over sequence chunks of this length (0: one
    # loss over the full logits)
    ce_chunk: int = 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Physical vocab rows: padded to 256 (padding logits are masked
        out)."""
        return ((self.vocab + 255) // 256) * 256

    def moe_settings(self) -> M.MoESettings:
        return M.MoESettings(
            self.n_experts, self.top_k, self.d_expert_ff, self.capacity_factor
        )

    def is_global_layers(self) -> list[bool]:
        if self.global_every <= 0:
            return [True] * self.n_layers
        return [(i + 1) % self.global_every == 0 for i in range(self.n_layers)]

    def rope_thetas(self) -> list[float]:
        if self.rope_theta_local <= 0 or self.global_every <= 0:
            return [float(self.rope_theta)] * self.n_layers
        return [float(self.rope_theta) if g else float(self.rope_theta_local)
                for g in self.is_global_layers()]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator | None, cfg: TransformerConfig,
                ep: int = 1, *, device=None,
                ranks: "RankContext | None" = None) -> dict:
    """Seeded random weights: `dense_init`'s scaled normal drawn from `gen`,
    on its device. `gen=None` draws on `device` from torch's default
    generator (`device="meta"`: the shapes alone). `ep` = size of the
    expert axis (for expert padding). One layer's experts are drawn and
    copied to every layer, as in the reference. With `ranks`, ep is the
    size of their expert axis ("model") and only this rank's experts are
    kept (`shard_params` of the whole draw, which is made for one layer
    only)."""
    device = gen.device if gen is not None else torch.device(device)
    if ranks is not None:
        ep = ranks.axis_size(EXPERT_AXIS)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    lyr = cfg.n_layers
    dt = cfg.dtype

    def w(shape, fan_in):
        return L.dense_init(gen, shape, fan_in, dt, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    attn = {
        "wq": w((lyr, d, h * dh), d),
        "wk": w((lyr, d, kv * dh), d),
        "wv": w((lyr, d, kv * dh), d),
        "wo": w((lyr, h * dh, d), h * dh),
    }
    if cfg.qkv_bias:
        attn["bq"] = zeros((lyr, h * dh))
        attn["bk"] = zeros((lyr, kv * dh))
        attn["bv"] = zeros((lyr, kv * dh))
    if cfg.qk_norm:
        attn["qnorm"] = zeros((lyr, dh))
        attn["knorm"] = zeros((lyr, dh))
    blocks: dict[str, Any] = {
        "ln1": zeros((lyr, d)),
        "ln2": zeros((lyr, d)),
        "attn": attn,
    }
    if cfg.is_moe:
        moe0 = M.init_moe_params(gen, d, cfg.moe_settings(), ep, dt, device)
        moe0 = {k: _local_experts(k, a, ranks, 0)
                for k, a in moe0._asdict().items()}
        blocks["moe"] = {
            k: a.unsqueeze(0).expand((lyr,) + a.shape).clone()
            for k, a in moe0.items()
        }
    else:
        blocks["ffn"] = {
            "w_gate": w((lyr, d, cfg.d_ff), d),
            "w_up": w((lyr, d, cfg.d_ff), d),
            "w_down": w((lyr, cfg.d_ff, d), cfg.d_ff),
        }
    params = {
        "embed": w((cfg.padded_vocab, d), d),
        "blocks": blocks,
        "ln_f": zeros((d,)),
    }
    if not cfg.tied_embeddings:
        params["head"] = w((d, cfg.padded_vocab), d)
    return params


def _local_experts(name: str, a: torch.Tensor, ranks, dim: int):
    """Expert weight `name` cut to this rank's experts along `dim` (the
    router stays whole); all of it without a rank context."""
    if ranks is None or name == "router":
        return a
    ep, er = ranks.axis_size(EXPERT_AXIS), ranks.axis_index(EXPERT_AXIS)
    e_local = a.shape[dim] // ep
    return a.narrow(dim, er * e_local, e_local).clone()


def shard_params(params: dict, ranks: "RankContext") -> dict:
    """Whole params (every expert, e.g. from `params_from_numpy`) as this
    rank's: the MoE expert rows of its coordinate on the expert axis;
    every other leaf replicated, as it is."""
    if "moe" not in params["blocks"]:
        return params
    blocks = dict(params["blocks"])
    blocks["moe"] = {k: _local_experts(k, a, ranks, 1)
                     for k, a in blocks["moe"].items()}
    return dict(params, blocks=blocks)


def _leaves(tree: dict):
    """(name, leaf) pairs, e.g. ("blocks/attn/wq", tensor), in leaf order."""
    return zip(TT.paths(tree), TT.leaves(tree))


def count_params(cfg: TransformerConfig, ep: int = 1) -> tuple[int, int]:
    """(total, active) parameter counts — active discounts unused experts."""
    shapes = init_params(None, cfg, ep, device="meta")
    total = sum(a.numel() for _, a in _leaves(shapes))
    # discount dead vocab-padding rows from the 'useful param' count
    pad_rows = cfg.padded_vocab - cfg.vocab
    total -= pad_rows * cfg.d_model * (1 if cfg.tied_embeddings else 2)
    active = total
    if cfg.is_moe:
        st = cfg.moe_settings()
        per_expert = 3 * cfg.d_model * cfg.d_expert_ff
        expert_total = cfg.n_layers * st.e_pad(ep) * per_expert
        expert_active = cfg.n_layers * cfg.top_k * per_expert
        active = total - expert_total + expert_active
    return total, active


def params_from_numpy(tree: dict, cfg: TransformerConfig, device) -> dict:
    """The reference's param pytree, as numpy arrays
    (`jax.tree.map(np.asarray, params)`), as this port's params dict on
    `device`: the same keys and shapes, every leaf bit for bit. bfloat16
    leaves (numpy arrays of the `bfloat16` extension dtype, which
    `torch.from_numpy` refuses) cross as their uint16 bit patterns."""
    want = dict(_leaves(init_params(None, cfg, device="meta")))
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"param keys differ: {sorted(set(got) ^ set(want))}")

    def leaf(name: str, arr) -> torch.Tensor:
        arr = np.array(arr, copy=True, order="C")  # writable, owned by torch
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(want[name].shape)}")
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device)

    def walk(node: dict, prefix: str) -> dict:
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaf(f"{prefix}{k}", v) for k, v in node.items()}

    return walk(tree, "")


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layers(blocks: dict, n_layers: int) -> list[dict]:
    """Each layer's weights out of the stacked block weights: views from
    one `unbind` per leaf, so a backward stacks each leaf's gradient once
    (indexing layer by layer would give each layer's backward a zero
    gradient the size of the whole stack)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    views = split(blocks)
    return [pick(views, i) for i in range(n_layers)]


def _attn_params(p: dict) -> L.AttnParams:
    a = p["attn"]
    return L.AttnParams(wq=a["wq"], wk=a["wk"], wv=a["wv"], wo=a["wo"],
                        bq=a.get("bq"), bk=a.get("bk"), bv=a.get("bv"))


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """Token embeddings, scaled by sqrt(d_model) ROUNDED TO THE CONFIG'S
    DTYPE as the reference does (34.0 for gemma3-1b in bf16)."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    return x


def _ffn(p: dict, h: torch.Tensor, cfg: TransformerConfig, *,
         decode: bool, ranks=None, count_dropped: bool = False):
    """The block's FFN: SwiGLU, or MoE (the sort-based dispatch at
    prefill, the one-hot einsum at decode). With `ranks` the experts are
    sharded over their expert axis and `h` is the same on every rank:
    at prefill each rank takes its S / ep slice of the sequence through
    the expert-parallel layer and the outputs are gathered back along S,
    as the reference's shard_map does (forward only: a gradient through
    that gather raises). Returns (y, n): n is the MoE prefill's capacity
    drops on this rank with `count_dropped` (a 0-d int64 tensor), else
    None."""
    if not cfg.is_moe:
        return L.swiglu_ffn(L.FFNParams(**p["ffn"]), h), None
    st = cfg.moe_settings()
    mp = M.MoEParams(**{k: p["moe"][k] for k in M.MoEParams._fields})
    e_pad = mp.router.shape[-1]
    if decode:
        return M.moe_ffn_onehot(mp, h, st, e_pad, ranks=ranks,
                                expert_axis=EXPERT_AXIS), None
    ep, er, group = M.expert_group(ranks, EXPERT_AXIS)
    if ep == 1:
        out = M.moe_ffn_ep_local(mp, h, st, count_dropped=count_dropped)
    else:
        s = h.shape[1]
        if s % ep:
            raise ValueError(f"a sequence of {s} does not split over {ep} "
                             "expert ranks")
        s_loc = s // ep
        out = M.moe_ffn_ep_local(mp, h[:, er * s_loc:(er + 1) * s_loc], st,
                                 ranks=ranks, expert_axis=EXPERT_AXIS,
                                 count_dropped=count_dropped)
    y, n = out if count_dropped else (out, None)
    if ep > 1:
        y = D.gather_replicated(y, group, dim=1)
    return y, n


def _head(params: dict, x: torch.Tensor, cfg: TransformerConfig):
    """Logits over the padded vocab; padding columns at NEG_INF."""
    head = params["embed"].T if cfg.tied_embeddings else params["head"]
    logits = x @ head.to(cfg.dtype)
    if cfg.padded_vocab != cfg.vocab:  # mask dead padding columns
        dead = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(dead, L.NEG_INF)
    return logits


def _block(x, p, cfg: TransformerConfig, is_global: bool, window: int,
           theta: float, ranks=None, count_dropped: bool = False):
    """One pre-norm block: attention, then the FFN, each residual. Returns
    (x, post-RoPE K, V, the FFN's drop count or None; see `_ffn`)."""
    h = L.rms_norm(x, p["ln1"])
    attn_out, kc, vc = _attention_prefill_cached(
        _attn_params(p), h, cfg, is_global=is_global, window=window,
        theta=theta, qk=(p["attn"].get("qnorm"), p["attn"].get("knorm")),
    )
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"])
    y, n = _ffn(p, h2, cfg, decode=False, ranks=ranks,
                count_dropped=count_dropped)
    return x + y, kc, vc, n


def _forward_trunk(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   *, collect_cache: bool = False, ranks=None, dropped=None):
    """Embed + layer stack + final norm. Returns (x, aux, caches|None);
    caches are the stacked post-RoPE (K, V), each (L, B, S, K, Dh). A
    forward that records a gradient rematerializes each block in the
    backward when `cfg.remat` is set. `ranks`: the experts are sharded
    over their expert axis (params from `shard_params` or
    `init_params(ranks=)`), and `dropped` (a 0-d int64 tensor) gets the
    MoE capacity drops of this forward added, once a layer, outside the
    remat (see `moe.moe_ffn_ep_local`)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    window = cfg.sliding_window if cfg.sliding_window > 0 else s + 1
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    layers = _layers(params["blocks"], cfg.n_layers)
    count = dropped is not None and cfg.is_moe
    ks, vs = [], []
    for p, is_global, theta in zip(layers, cfg.is_global_layers(),
                                   cfg.rope_thetas()):
        if remat:
            x, _, _, n = checkpoint(_block, x, p, cfg, is_global, window,
                                    theta, ranks, count, use_reentrant=False)
        else:
            x, kc, vc, n = _block(x, p, cfg, is_global, window, theta,
                                  ranks, count)
            if collect_cache:
                ks.append(kc)
                vs.append(vc)
        if count:
            dropped += n
    x = L.rms_norm(x, params["ln_f"])

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_moe:
        # Load-balance loss from the last layer's router on the final
        # hidden state (the reference's cheap proxy).
        st = cfg.moe_settings()
        last = M.MoEParams(**layers[-1]["moe"])
        aux = M.moe_aux_loss(last, x, st, last.router.shape[-1])
    caches = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, aux, caches


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            collect_cache: bool = False, ranks=None, dropped=None):
    """Full-sequence forward. Returns (logits, aux_loss, caches|None)."""
    x, aux, caches = _forward_trunk(params, tokens, cfg,
                                    collect_cache=collect_cache, ranks=ranks,
                                    dropped=dropped)
    return _head(params, x, cfg), aux, caches


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """forward() up to the final RMSNorm — no head projection. Returns
    (x, aux_loss)."""
    x, aux, _ = _forward_trunk(params, tokens, cfg)
    return x, aux


def _attention_prefill_cached(ap, h, cfg, *, is_global, window, theta, qk):
    """attention_prefill + expose post-RoPE K/V for prefill cache export."""
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None, :]
    q, k, v = L._project_qkv(ap, h, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    if qk[0] is not None:
        q = L.rms_norm(q, qk[0])
        k = L.rms_norm(k, qk[1])
    q = L.rope(q, positions, theta)
    k = L.rope(k, positions, theta)
    out = _flash_core(q, k, v, cfg, is_global=is_global, window=window)
    return out.to(h.dtype) @ ap.wo, k, v


def _flash_core(q, k, v, cfg, *, is_global, window):
    """Online-softmax over KV chunks (shared by prefill paths). The chunk
    is min(kv_chunk, S); a longer prompt must be a whole number of them."""
    s, dh = q.shape[1], q.shape[-1]
    kv_chunk = L.kv_chunk_len(s, cfg.kv_chunk)
    return L.online_softmax(q * (dh**-0.5), k, v, kv_chunk=kv_chunk,
                            is_global=is_global, window=window)


# ---------------------------------------------------------------------------
# Loss + train step
# ---------------------------------------------------------------------------

def _label_logit(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit rounded to bf16 and back, as the reference's
    one-hot einsum in bf16 gives it; the backward of those casts rounds
    the label's cotangent to bf16 the same way."""
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return ll.to(torch.bfloat16).to(torch.float32)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4):
    """(nll + z_loss * mean(lse^2), nll): cross-entropy with a z-loss, the
    logits in float32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    nll = torch.mean(lse - _label_logit(lf, labels))
    return nll + z_loss * torch.mean(lse**2), nll


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                    cfg: TransformerConfig, z_loss: float = 1e-4):
    """Head projection + CE over sequence chunks of `cfg.ce_chunk` (one
    chunk when S is not a multiple of it), summed in chunk order."""
    b, s, d = x.shape
    c = cfg.ce_chunk if (cfg.ce_chunk and s % cfg.ce_chunk == 0) else s
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        logits = x[:, c0:c0 + c] @ head.to(x.dtype)  # (B, c, V)
        if cfg.padded_vocab != cfg.vocab:
            dead = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(dead, L.NEG_INF)
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        ll = _label_logit(lf, labels[:, c0:c0 + c])
        nll_sum = nll_sum + torch.sum(lse - ll)
        z_sum = z_sum + torch.sum(lse**2)
    n = b * s
    return nll_sum / n + z_loss * z_sum / n, nll_sum / n


def make_loss_fn(cfg: TransformerConfig, aux_weight: float = 0.01):
    """loss_fn(params, tokens, labels) -> (total, {"loss": nll, "aux"})."""
    use_chunked = cfg.ce_chunk > 0

    def loss_fn(params, tokens, labels):
        if use_chunked:
            x, aux = forward_hidden(params, tokens, cfg)
            head = (params["embed"].T if cfg.tied_embeddings
                    else params["head"])
            total, nll = chunked_ce_loss(x, head, labels, cfg)
        else:
            logits, aux, _ = forward(params, tokens, cfg)
            total, nll = ce_loss(logits, labels)
        total = total + aux_weight * aux
        return total, {"loss": nll, "aux": aux}

    return loss_fn


def make_train_step(cfg: TransformerConfig, opt_cfg: AdamWConfig,
                    n_micro: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); batch: {"tokens", "labels"} (B, S) int32 on the params'
    device. With `n_micro` > 1 the batch is split into that many
    micro-batches whose gradients are summed in float32 and averaged;
    the loss metrics are the last micro-batch's. Metrics are 0-d tensors
    on the device (no host sync)."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, tokens, labels):
        return TT.grad(loss_fn, params, tokens, labels)

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if n_micro == 1:
            grads, metrics = grad_fn(params, tokens, labels)
        else:
            mb = tokens.shape[0] // n_micro
            tk = tokens.reshape(n_micro, mb, -1)
            lb = labels.reshape(n_micro, mb, -1)
            grads = TT.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for t, lab in zip(tk, lb):
                g, metrics = grad_fn(params, t, lab)
                grads = TT.map(lambda a, x: a + x.to(torch.float32), grads, g)
                del g
            grads = TT.map(lambda g: g / n_micro, grads)
        new_params, new_state, om = adamw_update(opt_cfg, grads, opt_state,
                                                 params)
        return new_params, new_state, dict(metrics, **om)

    return train_step


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: TransformerConfig, ranks=None, dropped=None):
    """prefill: (params, tokens (B, S)) -> (next (B,) int32, kc, vc);
    kc/vc: (L, B, S, K, Dh) in the config's dtype. `ranks`, `dropped`:
    as `forward`'s."""
    def prefill_step(params, tokens):
        logits, _, (kc, vc) = forward(params, tokens, cfg, collect_cache=True,
                                      ranks=ranks, dropped=dropped)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, kc.to(cfg.dtype), vc.to(cfg.dtype)

    return prefill_step


def decode_logits(params: dict, kc: torch.Tensor, vc: torch.Tensor, pos: int,
                  tokens: torch.Tensor, cfg: TransformerConfig,
                  ranks=None) -> torch.Tensor:
    """One decode step's logits (B, V_pad) for `tokens` (B,) at position
    `pos` (a host int, the current cache length); writes the new K/V into
    kc/vc (L, B, S_max, K, Dh) in place. `ranks`: the experts are sharded
    over their expert axis (the one-hot dispatch per rank, summed)."""
    x = _embed(params, tokens, cfg)[:, None, :]  # (B, 1, D)
    window = cfg.sliding_window if cfg.sliding_window > 0 else kc.shape[2] + 1
    layers = _layers(params["blocks"], cfg.n_layers)
    for i, (p, is_global, theta) in enumerate(
            zip(layers, cfg.is_global_layers(), cfg.rope_thetas())):
        h = L.rms_norm(x, p["ln1"])
        attn_out = _decode_attn(
            _attn_params(p), h, kc[i], vc[i], pos, cfg, is_global, window,
            theta, qk=(p["attn"].get("qnorm"), p["attn"].get("knorm")),
        )
        x = x + attn_out
        h2 = L.rms_norm(x, p["ln2"])
        x = x + _ffn(p, h2, cfg, decode=True, ranks=ranks)[0]
    x = L.rms_norm(x, params["ln_f"])
    return _head(params, x, cfg)[:, 0, :]


def make_serve_step(cfg: TransformerConfig, ranks=None):
    """decode: (params, kc, vc, pos, tokens (B,)) -> (next (B,), kc, vc).
    kc/vc: (L, B, S_max, K, Dh), updated in place and returned; pos: host
    int, the current cache length."""
    def serve_step(params, kc, vc, pos, tokens):
        logits = decode_logits(params, kc, vc, pos, tokens, cfg, ranks)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, kc, vc

    return serve_step


def _decode_attn(ap, x, kc, vc, pos, cfg, is_global, window, theta, qk):
    """One layer's decode attention; kc/vc: (B, S_max, K, Dh) views into
    the stacked cache, written in place at `pos`."""
    q, k_new, v_new = L._project_qkv(ap, x, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.d_head)
    if qk[0] is not None:
        q = L.rms_norm(q, qk[0])
        k_new = L.rms_norm(k_new, qk[1])
    posb = torch.arange(pos, pos + 1, dtype=torch.int32,
                        device=x.device).expand(x.shape[0], 1)
    q = L.rope(q, posb, theta)
    k_new = L.rope(k_new, posb, theta)
    o = L.decode_core(q, k_new, v_new, kc, vc, pos, scale=cfg.d_head**-0.5,
                      is_global=is_global, window=window)
    return o.to(x.dtype) @ ap.wo


def init_decode_cache(cfg: TransformerConfig, batch: int, s_max: int,
                      device=None):
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


# ---------------------------------------------------------------------------
# Roofline bookkeeping
# ---------------------------------------------------------------------------

def model_flops(cfg: TransformerConfig, kind: str, batch: int, seq: int,
                ep: int = 1) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (+attention) for inference."""
    total, active = count_params(cfg, ep)
    n_tok = batch * seq
    attn = 4.0 * n_tok * seq * cfg.n_heads * cfg.d_head  # QK^T + PV (causal/2 applied below)
    if kind == "train":
        return 6.0 * active * n_tok + 3.0 * attn / 2
    if kind == "prefill":
        return 2.0 * active * n_tok + attn / 2
    # decode: one token per sequence over a seq-long cache
    return 2.0 * active * batch + 4.0 * batch * seq * cfg.n_heads * cfg.d_head

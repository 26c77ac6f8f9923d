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
`init_params(ranks=)` or `shard_params(..., serve_specs(cfg))`, then `ranks=` to the forward and
the serving steps). With `cfg.remat` a training forward rematerializes
each block in the backward (`torch.utils.checkpoint`, as the reference's
`jax.checkpoint` of the scanned block).

Training: `ce_loss` / `chunked_ce_loss`, `make_loss_fn` and
`make_train_step` (gradients by `torch.autograd.grad` over the param
leaves, optional micro-batch accumulation in float32, then AdamW). Across
the ranks of a ("data", "model") mesh (`make_train_step(ranks=)`) the
params are plain local blocks cut by `param_specs` (`shard_params(...,
specs)`) and the forward is the reference's sharded one written out with
`core.distributed`'s collectives (`MeshLayout`): the batch cut over the
data axes, Megatron tensor parallelism on "model" (the attention's heads
and the FFN's hidden units, the embedding and head by vocab, the loss's
logsumexp across the vocab shards), the sequence cut over "model"
between blocks under `cfg.seq_shard`, the MoE block's tokens routed
expert-parallel from the ranks' sequence slices, and under `cfg.fsdp`
each block's "data"-cut weights all-gathered just before use (again in
a remat's backward).

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as TT
from repro_torch.core import distributed as D
from repro_torch.core import specs as S
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
    # distribution: read by the training forward across ranks
    # (`MeshLayout`); one device reads neither, and the layer loop is
    # plain Python, so there is no scan to unroll
    fsdp: bool = False  # "data" cuts on the fs dims (`param_specs`)
    seq_shard: bool = True  # the sequence cut over "model" between blocks
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
        if ranks is not None:
            cut = serve_specs(cfg)["blocks"]["moe"]
            moe0 = M.MoEParams(**{k: S.shard(a, cut[k][1:], ranks)
                                  for k, a in moe0._asdict().items()})
        blocks["moe"] = {
            k: a.unsqueeze(0).expand((lyr,) + a.shape).clone()
            for k, a in moe0._asdict().items()
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


def shard_params(params: dict, ranks: "RankContext", specs: dict) -> dict:
    """Whole params (e.g. from `params_from_numpy`, or seeded on every
    rank alike) as this rank's blocks, every leaf cut by `specs`:
    `param_specs` (training) or `serve_specs` (serving)."""
    return S.shard_tree(params, specs, ranks)


# ---------------------------------------------------------------------------
# Partition specs (the reference's, as tuples: one axis name, tuple of
# names or None per dim; see core/specs.py)
# ---------------------------------------------------------------------------

def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def param_specs(cfg: TransformerConfig, multi_pod: bool = False,
                model_size: int = 1) -> dict:
    fs = "data" if cfg.fsdp else None
    kv_shardable = (cfg.n_kv_heads % model_size == 0)
    kvs = "model" if kv_shardable else None
    attn = {
        "wq": (None, fs, "model"),
        "wk": (None, fs, kvs),
        "wv": (None, fs, kvs),
        "wo": (None, "model", fs),
    }
    if cfg.qkv_bias:
        attn.update(bq=(None, "model"), bk=(None, kvs), bv=(None, kvs))
    if cfg.qk_norm:
        attn.update(qnorm=(None, None), knorm=(None, None))
    blocks: dict[str, Any] = {
        "ln1": (None, None),
        "ln2": (None, None),
        "attn": attn,
    }
    if cfg.is_moe:
        blocks["moe"] = {
            "router": (None, None, None),
            "we_gate": (None, "model", fs, None),
            "we_up": (None, "model", fs, None),
            "we_down": (None, "model", None, fs),
        }
    else:
        blocks["ffn"] = {
            "w_gate": (None, fs, "model"),
            "w_up": (None, fs, "model"),
            "w_down": (None, "model", fs),
        }
    specs = {
        "embed": ("model", fs),
        "blocks": blocks,
        "ln_f": (None,),
    }
    if not cfg.tied_embeddings:
        specs["head"] = (fs, "model")
    return specs


def serve_specs(cfg: TransformerConfig) -> dict:
    """The serving layout: the MoE experts cut over the expert axis,
    every other leaf whole on every rank."""
    def whole(node):
        if isinstance(node, dict):
            return {k: whole(v) for k, v in node.items()}
        return ()

    specs = whole(param_specs(cfg))
    if cfg.is_moe:
        specs["blocks"]["moe"].update(
            {k: (None, EXPERT_AXIS) for k in ("we_gate", "we_up", "we_down")})
    return specs


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


class MeshLayout:
    """How the training forward runs on this rank of a ("data", "model")
    mesh, its params cut by `specs` (`param_specs`). Written out with the
    explicit collectives of `core.distributed`, every rank's loss counting
    once in the total (their convention): a replicated activation's
    gradient on a rank is its part of the whole, and the leaves' parts
    are summed over their replica axes after the backward
    (`specs.reduce_grads`).

    - data axes: each rank holds its rows of the batch;
    - "model" (Megatron tensor parallelism): wq, wk, wv and w_gate, w_up
      cut by columns (the rank's heads and hidden units), wo and w_down
      by rows, one all-reduce after each (a reduce-scatter along the
      sequence under `seq_shard`, whose x is cut on the sequence between
      blocks and all-gathered before attention and the FFN); wk / wv
      whole when the KV heads do not split (`kv_shardable`), each rank
      keeping the KV heads its query heads read; the embedding cut by
      vocab (the owned rows gathered, then summed), the head by vocab
      (`ce_loss`'s logsumexp across the shards); the MoE block
      expert-parallel from the ranks' sequence slices;
    - heads that do not split over "model" (wq's columns cut inside a
      head, as the reference's spec cuts them for 24, 40 or 4 heads over
      16): the attention's weights are all-gathered over "model" and
      the attention runs sequence-parallel, each rank's queries over its
      sequence slice against the keys and values all-gathered along the
      sequence (it needs `seq_shard`); no all-reduce after it;
    - `fsdp`: a weight's "data" cut all-gathered just before its use,
      with the backward reduce-scattering its gradient to the block;
    - a ("pod", "data", "model") mesh: the data axes are ("pod", "data")
      (`dp_axes(True)`), FSDP and ZeRO-1 cut over "data" alone."""

    def __init__(self, cfg: TransformerConfig, ranks: "RankContext",
                 specs: dict, seq_shard: "bool | None" = None):
        names = tuple(ranks.mesh.axis_names)
        if EXPERT_AXIS not in names or "data" not in names:
            raise ValueError(f"a training mesh over (data, model), not "
                             f"{names}")
        self.cfg, self.ranks, self.specs = cfg, ranks, specs
        self.model = ranks.axis_size(EXPERT_AXIS)
        self.m = ranks.axis_index(EXPERT_AXIS)
        self.mgroup = ranks.group(EXPERT_AXIS)
        self.dp = dp_axes("pod" in names)
        self.n_data = ranks.axis_size(self.dp)
        self.dgroup = ranks.group(self.dp)
        seq = cfg.seq_shard if seq_shard is None else seq_shard
        self.seq = seq and self.model > 1
        token_axes = tuple(a for a in names if ranks.axis_size(a) > 1
                           and (a in self.dp or (a == EXPERT_AXIS
                                                 and self.seq)))
        self.token_group = ranks.group(token_axes) if token_axes else None
        self.token_ranks = ranks.axis_size(token_axes) if token_axes else 1
        h, kv = cfg.n_heads, cfg.n_kv_heads
        # heads that do not split over "model" (wq cut inside a head):
        # the attention runs sequence-parallel on the gathered weights
        self.heads_tp = h % self.model == 0
        if not self.heads_tp:
            self.n_q, self.n_kv, self.kv_keep = h, kv, None
            return
        self.n_q = h // self.model
        kv_cut = EXPERT_AXIS in S.axes_of(specs["blocks"]["attn"]["wk"])
        g = h // kv
        if kv_cut:
            self.n_kv, self.kv_keep = kv // self.model, None
        elif g % self.n_q == 0:  # this rank's query heads read one KV head
            self.n_kv, self.kv_keep = kv, (self.m * self.n_q) // g
        else:
            raise ValueError(f"{h} query heads over {kv} KV heads do not "
                             f"split over {self.model} model ranks")

    @property
    def vocab_start(self) -> int:
        return self.m * (self.cfg.padded_vocab // self.model)

    def full(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """`x` with its "data" (FSDP) cuts all-gathered; its backward
        reduce-scatters the gradient back to this rank's block."""
        if self.n_data == 1:
            return x
        for dim, e in enumerate(S.norm(spec, x.dim())):
            if "data" in S.entry_axes(e):
                x = S.gather_dim(x, self.ranks.group("data"), dim, grad=True)
        return x

    def layer_weights(self, p: dict) -> dict:
        """One layer's weights (views without the layer axis) with their
        FSDP cuts gathered."""
        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            return self.full(node, tuple(spec)[1:])

        return walk(p, self.specs["blocks"])

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """The whole sequence before a tensor-parallel layer: all-gathered
        over "model" under seq_shard (backward: reduce-scatter)."""
        if not self.seq:
            return h
        return S.gather_dim(h, self.mgroup, 1, grad=True)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial outputs of a tensor-parallel
        layer: this rank's sequence slice of it under seq_shard (a
        reduce-scatter), else all of it (an all-reduce)."""
        if self.model == 1:
            return y
        if self.seq:
            return D.reduce_scatter_rows(y.movedim(1, 0),
                                         self.mgroup).movedim(0, 1)
        return D.all_reduce_sum(y, self.mgroup)

    def whole_attn(self, p: dict) -> L.AttnParams:
        """One layer's attention weights with their "model" cuts
        all-gathered (backward: reduce-scatter)."""
        spec = self.specs["blocks"]["attn"]
        whole = {}
        for name, w in p["attn"].items():
            for dim, e in enumerate(S.norm(tuple(spec[name])[1:], w.dim())):
                if EXPERT_AXIS in S.entry_axes(e) and self.model > 1:
                    w = S.gather_dim(w, self.mgroup, dim, grad=True)
            whole[name] = w
        return _attn_params({"attn": whole})

    def attention(self, p: dict, h: torch.Tensor, cfg: TransformerConfig, *,
                  is_global: bool, window: int, theta: float):
        """(attention output, post-RoPE K, V) of one layer on this rank:
        the output summed over "model" (this rank's sequence slice of it
        under seq_shard), K and V of the whole sequence and of this
        rank's KV heads (all of them when the heads do not split)."""
        qk = (p["attn"].get("qnorm"), p["attn"].get("knorm"))
        if self.heads_tp:
            out, k, v = _attention_prefill_cached(
                _attn_params(p), self.enter(h), cfg, is_global=is_global,
                window=window, theta=theta, qk=qk,
                heads=(self.n_q, self.n_kv, self.kv_keep))
            return self.exit(out), k, v
        if not self.seq:
            raise ValueError(f"{cfg.n_heads} heads do not split over "
                             f"{self.model} model ranks: the attention "
                             "runs sequence-parallel, under seq_shard")
        ap = self.whole_attn(p)
        s_loc = h.shape[1]
        start = self.m * s_loc
        positions = start + torch.arange(s_loc, dtype=torch.int32,
                                         device=h.device)[None, :]
        q, k, v = L._project_qkv(ap, h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.d_head)
        if qk[0] is not None:
            q = L.rms_norm(q, qk[0])
            k = L.rms_norm(k, qk[1])
        q = L.rope(q, positions, theta)
        k = S.gather_dim(L.rope(k, positions, theta), self.mgroup, 1,
                         grad=True)
        v = S.gather_dim(v, self.mgroup, 1, grad=True)
        out = L.online_softmax(
            q * (cfg.d_head**-0.5), k, v,
            kv_chunk=L.kv_chunk_len(k.shape[1], cfg.kv_chunk),
            is_global=is_global, window=window, q_offset=start)
        return out.to(h.dtype) @ ap.wo, k, v

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axes of a 0-d metric (no gradient)."""
        if self.n_data == 1:
            return x
        return S.all_reduce_(x.detach().clone().reshape(1),
                              self.dgroup).reshape(()) / self.n_data


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
           lay: "MeshLayout | None" = None):
    """Token embeddings, scaled by sqrt(d_model) ROUNDED TO THE CONFIG'S
    DTYPE as the reference does (34.0 for gemma3-1b in bf16). The rows are
    read by `F.embedding`, whose backward sums each row's gradient in
    float32: an index's backward on the card sums a bf16 table's in bf16,
    and a frequent token's row loses its small terms.
    With `lay` the table is cut by vocab: each rank reads the tokens it
    owns (zero rows for the rest) and the rows are summed over "model"
    (this rank's sequence slice of the sum under seq_shard)."""
    if lay is None:
        x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    else:
        emb = lay.full(params["embed"], lay.specs["embed"])
        if lay.model == 1:
            x = F.embedding(tokens.long(), emb)
        else:
            t = tokens.long() - lay.vocab_start
            own = (t >= 0) & (t < emb.shape[0])
            rows = F.embedding(t.clamp(0, emb.shape[0] - 1), emb)
            x = lay.exit(torch.where(own[..., None], rows, 0.0))
        x = x.to(cfg.dtype)
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    return x


def _ffn(p: dict, h: torch.Tensor, cfg: TransformerConfig, *,
         decode: bool, ranks=None, count_dropped: bool = False,
         lay: "MeshLayout | None" = None):
    """The block's FFN: SwiGLU, or MoE (the sort-based dispatch at
    prefill, the one-hot einsum at decode). With `ranks` (serving) the
    experts are sharded over their expert axis and `h` is the same on
    every rank: at prefill each rank takes its S / ep slice of the
    sequence through the expert-parallel layer and the outputs are
    gathered back along S, as the reference's shard_map does. With `lay`
    (training across ranks) the dense FFN is tensor-parallel and the MoE
    layer takes this rank's sequence slice (`h` already is one under
    seq_shard; else the replicated pair cuts and regathers it). Returns
    (y, n): n is the MoE prefill's capacity drops on this rank with
    `count_dropped` (a 0-d int64 tensor), else None."""
    if not cfg.is_moe:
        if lay is None:
            return L.swiglu_ffn(L.FFNParams(**p["ffn"]), h), None
        y = L.swiglu_ffn(L.FFNParams(**p["ffn"]), lay.enter(h))
        return lay.exit(y), None
    st = cfg.moe_settings()
    mp = M.MoEParams(**{k: p["moe"][k] for k in M.MoEParams._fields})
    e_pad = mp.router.shape[-1]
    if decode:
        return M.moe_ffn_onehot(mp, h, st, e_pad, ranks=ranks,
                                expert_axis=EXPERT_AXIS), None
    if lay is not None:
        ranks = lay.ranks if lay.model > 1 else None
    ep, er, group = M.expert_group(ranks, EXPERT_AXIS)
    drops = []

    def moe(tokens):
        out = M.moe_ffn_ep_local(mp, tokens, st,
                                 ranks=ranks if ep > 1 else None,
                                 expert_axis=EXPERT_AXIS,
                                 count_dropped=count_dropped)
        if not count_dropped:
            return out
        drops.append(out[1])
        return out[0]

    if ep == 1 or (lay is not None and lay.seq):
        # one shard, or the tokens are this rank's sequence slice already
        y = moe(h)
    elif lay is not None:  # training: gradients in parts, as `lay`'s
        y = S.gather_dim(moe(S.shard(h, (None, EXPERT_AXIS), ranks)), group,
                         1, grad=True)
    else:  # serving: forward only
        y = D.gather_replicated(moe(D.split_replicated(h, group, 1)), group,
                                dim=1)
    return y, (drops[0] if count_dropped else None)


def _head_weight(params: dict, cfg: TransformerConfig,
                 lay: "MeshLayout | None" = None) -> torch.Tensor:
    """The (D, V_pad) head (this rank's vocab columns with `lay`)."""
    if cfg.tied_embeddings:
        emb = params["embed"]
        return (emb if lay is None else lay.full(emb, lay.specs["embed"])).T
    if lay is None:
        return params["head"]
    return lay.full(params["head"], lay.specs["head"])


def _mask_padding(logits: torch.Tensor, cfg: TransformerConfig,
                  start: int = 0) -> torch.Tensor:
    """Padding columns (global index >= vocab) at NEG_INF; the columns
    are the vocab's from `start` on."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    cols = start + torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= cfg.vocab, L.NEG_INF)


def _head(params: dict, x: torch.Tensor, cfg: TransformerConfig):
    """Logits over the padded vocab; padding columns at NEG_INF."""
    return _mask_padding(x @ _head_weight(params, cfg).to(cfg.dtype), cfg)


def _block(x, p, cfg: TransformerConfig, is_global: bool, window: int,
           theta: float, ranks=None, count_dropped: bool = False,
           lay: "MeshLayout | None" = None):
    """One pre-norm block: attention, then the FFN, each residual. Returns
    (x, post-RoPE K, V, the FFN's drop count or None; see `_ffn`). With
    `lay` the block is this rank's share (its weights gathered here, so
    a remat gathers them again in the backward)."""
    if lay is None:
        attn_out, kc, vc = _attention_prefill_cached(
            _attn_params(p), L.rms_norm(x, p["ln1"]), cfg,
            is_global=is_global, window=window, theta=theta,
            qk=(p["attn"].get("qnorm"), p["attn"].get("knorm")),
        )
    else:
        p = lay.layer_weights(p)
        attn_out, kc, vc = lay.attention(p, L.rms_norm(x, p["ln1"]), cfg,
                                         is_global=is_global, window=window,
                                         theta=theta)
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"])
    y, n = _ffn(p, h2, cfg, decode=False, ranks=ranks,
                count_dropped=count_dropped, lay=lay)
    return x + y, kc, vc, n


def _forward_trunk(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   *, collect_cache: bool = False, ranks=None, dropped=None,
                   lay: "MeshLayout | None" = None):
    """Embed + layer stack + final norm. Returns (x, aux, caches|None);
    caches are the stacked post-RoPE (K, V), each (L, B, S, K, Dh). A
    forward that records a gradient rematerializes each block in the
    backward when `cfg.remat` is set. `ranks`: the experts are sharded
    over their expert axis (params from `shard_params` or
    `init_params(ranks=)`), and `dropped` (a 0-d int64 tensor) gets the
    MoE capacity drops of this forward added, once a layer, outside the
    remat (see `moe.moe_ffn_ep_local`). `lay`: the training forward
    across ranks (x this rank's rows, and its sequence slice under
    seq_shard; the aux loss over the whole batch)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, lay)
    window = cfg.sliding_window if cfg.sliding_window > 0 else s + 1
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    layers = _layers(params["blocks"], cfg.n_layers)
    count = dropped is not None and cfg.is_moe
    ks, vs = [], []
    for p, is_global, theta in zip(layers, cfg.is_global_layers(),
                                   cfg.rope_thetas()):
        if remat:
            x, _, _, n = checkpoint(_block, x, p, cfg, is_global, window,
                                    theta, ranks, count, lay,
                                    use_reentrant=False)
        else:
            x, kc, vc, n = _block(x, p, cfg, is_global, window, theta,
                                  ranks, count, lay)
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
        if lay is None:
            aux = M.moe_aux_loss(last, x, st, last.router.shape[-1])
        else:
            aux = _moe_aux_loss_mesh(last, x, st, lay)
    caches = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, aux, caches


def _moe_aux_loss_mesh(p: M.MoEParams, x: torch.Tensor, st: M.MoESettings,
                       lay: MeshLayout) -> torch.Tensor:
    """`moe.moe_aux_loss` over the whole batch: each rank's sums of the
    top-k indicators and the router's probabilities over its tokens,
    summed over the ranks that hold other tokens."""
    xf = x.reshape(-1, x.shape[-1])
    e_pad = p.router.shape[-1]
    probs = M._router_probs(p, xf, st, e_pad)
    _, eidx = M.top_k(probs, st.top_k)
    sums = torch.stack([M.one_hot(eidx, e_pad, torch.float32).sum(dim=(0, 1)),
                        probs.sum(dim=0)])
    if lay.token_group is not None:
        sums = D.all_reduce_sum(sums, lay.token_group)
    t = xf.shape[0] * lay.token_ranks
    return st.n_experts * torch.sum((sums[0] / t) * (sums[1] / t)) / st.top_k


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


def _attention_prefill_cached(ap, h, cfg, *, is_global, window, theta, qk,
                              heads=None):
    """attention_prefill + expose post-RoPE K/V for prefill cache export.
    `heads`: (query heads, KV heads projected, the one KV head kept or
    None) of this rank's share under tensor parallelism."""
    b, s, _ = h.shape
    n_q, n_kv, keep = heads or (cfg.n_heads, cfg.n_kv_heads, None)
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None, :]
    q, k, v = L._project_qkv(ap, h, n_q, n_kv, cfg.d_head)
    if keep is not None:
        k, v = k[:, :, keep:keep + 1], v[:, :, keep:keep + 1]
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


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """Logits cut by vocab over `group`: this rank's columns are the
    vocab's from `start` on."""
    group: Any
    start: int


def _lse_and_label(lf: torch.Tensor, labels: torch.Tensor,
                   shard: "VocabShard | None"):
    """(logsumexp, the label's logit) of float32 logits. Over a vocab
    shard: the max and the sum of exponentials across the shards (the
    max with no gradient: it only shifts), the label's logit from the
    rank that owns it, in the same bf16 chain, summed over the shards."""
    if shard is None:
        return torch.logsumexp(lf, dim=-1), _label_logit(lf, labels)
    mx = D.all_reduce_max(lf.amax(dim=-1), shard.group)
    total = D.all_reduce_sum(torch.exp(lf - mx[..., None]).sum(dim=-1),
                             shard.group)
    lse = mx + torch.log(total)
    local = labels.long() - shard.start
    own = (local >= 0) & (local < lf.shape[-1])
    ll = torch.gather(lf, -1, local.clamp(0, lf.shape[-1] - 1)[..., None])
    ll = torch.where(own, ll[..., 0].to(torch.bfloat16).to(torch.float32),
                     0.0)
    return lse, D.all_reduce_sum(ll, shard.group)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4,
            shard: "VocabShard | None" = None):
    """(nll + z_loss * mean(lse^2), nll): cross-entropy with a z-loss, the
    logits in float32. `shard`: the logits are this rank's vocab columns
    (every rank of its group with the same rows)."""
    lf = logits.to(torch.float32)
    lse, ll = _lse_and_label(lf, labels, shard)
    nll = torch.mean(lse - ll)
    return nll + z_loss * torch.mean(lse**2), nll


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                    cfg: TransformerConfig, z_loss: float = 1e-4,
                    shard: "VocabShard | None" = None):
    """Head projection + CE over sequence chunks of `cfg.ce_chunk` (one
    chunk when S is not a multiple of it), summed in chunk order.
    `shard`: `head` is this rank's vocab columns."""
    b, s, d = x.shape
    c = cfg.ce_chunk if (cfg.ce_chunk and s % cfg.ce_chunk == 0) else s
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, c):
        logits = x[:, c0:c0 + c] @ head.to(x.dtype)  # (B, c, V)
        logits = _mask_padding(logits, cfg, shard.start if shard else 0)
        lf = logits.to(torch.float32)
        lse, ll = _lse_and_label(lf, labels[:, c0:c0 + c], shard)
        nll_sum = nll_sum + torch.sum(lse - ll)
        z_sum = z_sum + torch.sum(lse**2)
    n = b * s
    return nll_sum / n + z_loss * z_sum / n, nll_sum / n


def make_loss_fn(cfg: TransformerConfig, aux_weight: float = 0.01,
                 lay: "MeshLayout | None" = None):
    """loss_fn(params, tokens, labels) -> (total, {"loss": nll, "aux"}).
    With `lay` the params are this rank's blocks and tokens / labels its
    rows; the loss is its data group's (the same on every rank of it)."""
    use_chunked = cfg.ce_chunk > 0

    def loss_fn(params, tokens, labels):
        if lay is not None:
            return _mesh_loss(params, tokens, labels, cfg, aux_weight, lay)
        if use_chunked:
            x, aux = forward_hidden(params, tokens, cfg)
            total, nll = chunked_ce_loss(x, _head_weight(params, cfg),
                                         labels, cfg)
        else:
            logits, aux, _ = forward(params, tokens, cfg)
            total, nll = ce_loss(logits, labels)
        total = total + aux_weight * aux
        return total, {"loss": nll, "aux": aux}

    return loss_fn


def _mesh_loss(params, tokens, labels, cfg, aux_weight, lay: MeshLayout):
    x, aux, _ = _forward_trunk(params, tokens, cfg, lay=lay)
    x = lay.enter(x)  # the logits hold the whole sequence, cut by vocab
    head = _head_weight(params, cfg, lay)
    shard = (VocabShard(lay.mgroup, lay.vocab_start) if lay.model > 1
             else None)
    if cfg.ce_chunk > 0:
        total, nll = chunked_ce_loss(x, head, labels, cfg, shard=shard)
    else:
        logits = _mask_padding(x @ head.to(cfg.dtype), cfg,
                               shard.start if shard else 0)
        total, nll = ce_loss(logits, labels, shard=shard)
    total = total + aux_weight * aux
    return total, {"loss": nll, "aux": aux}


def make_train_step(cfg: TransformerConfig, opt_cfg: AdamWConfig,
                    n_micro: int = 1, ranks: "RankContext | None" = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); batch: {"tokens", "labels"} (B, S) int32 on the params'
    device. With `n_micro` > 1 the batch is split into that many
    micro-batches whose gradients are summed in float32 and averaged;
    the loss metrics are the last micro-batch's. Metrics are 0-d tensors
    on the device (no host sync).

    `ranks` (a ("data", "model") or ("pod", "data", "model") mesh of
    more than one rank): the params are this rank's blocks by
    `param_specs(cfg, multi_pod, model size)`
    (`shard_params`), the opt state `adamw_init(params, specs, ranks)`'s (m and v cut by ZeRO-1 over "data"), and the batch
    this rank's rows of the global batch (its data coordinate's block;
    `data.tokens.data_rows`). Each rank seeds its backward with 1 /
    world of its data group's loss, so the seeds sum to the global loss;
    each leaf's gradient is summed over its replica axes (over a data
    axis, the mean of the data groups' gradients) before AdamW, whose
    bf16 compression comes after that mean. The loss metric is the mean
    over the data groups; aux and grad_norm are global. At one rank the
    step is the one-process step."""
    if ranks is not None and ranks.world_size > 1:
        specs = param_specs(cfg, "pod" in ranks.mesh.axis_names,
                            ranks.axis_size(EXPERT_AXIS))
        return _mesh_train_step(cfg, opt_cfg, n_micro, ranks, specs)
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, tokens, labels):
        return TT.grad(loss_fn, params, tokens, labels)

    def train_step(params, opt_state, batch):
        grads, metrics = _accumulate(grad_fn, params, batch, n_micro)
        new_params, new_state, om = adamw_update(opt_cfg, grads, opt_state,
                                                 params)
        return new_params, new_state, dict(metrics, **om)

    return train_step


def _accumulate(grad_fn, params, batch, n_micro: int):
    """(grads, metrics) of one batch, or of `n_micro` micro-batches: their
    gradients summed in float32 and averaged, the last one's metrics."""
    tokens, labels = batch["tokens"], batch["labels"]
    if n_micro == 1:
        return grad_fn(params, tokens, labels)
    mb = tokens.shape[0] // n_micro
    tk = tokens.reshape(n_micro, mb, -1)
    lb = labels.reshape(n_micro, mb, -1)
    grads = TT.map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for t, lab in zip(tk, lb):
        g, metrics = grad_fn(params, t, lab)
        grads = TT.map(lambda a, x: a + x.to(torch.float32), grads, g)
        del g
    return TT.map(lambda g: g / n_micro, grads), metrics


def _mesh_train_step(cfg, opt_cfg, n_micro, ranks, specs):
    lay = MeshLayout(cfg, ranks, specs)
    loss_fn = make_loss_fn(cfg, lay=lay)
    seed = 1.0 / ranks.world_size

    def seeded(params, tokens, labels):
        total, metrics = loss_fn(params, tokens, labels)
        return total * seed, metrics

    def grad_fn(params, tokens, labels):
        return TT.grad(seeded, params, tokens, labels)

    def train_step(params, opt_state, batch):
        grads, metrics = _accumulate(grad_fn, params, batch, n_micro)
        grads = S.reduce_grads(grads, specs, ranks)
        metrics = dict(metrics, loss=lay.data_mean(metrics["loss"]))
        new_params, new_state, om = adamw_update(
            opt_cfg, grads, opt_state, params, specs=specs, ranks=ranks)
        return new_params, new_state, dict(metrics, **om)

    return train_step


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: TransformerConfig, ranks=None, dropped=None,
                      specs: "dict | None" = None):
    """prefill: (params, tokens (B, S)) -> (next (B,) int32, kc, vc);
    kc/vc: (L, B, S, K, Dh) in the config's dtype. `ranks`, `dropped`:
    as `forward`'s (the serving layout, `serve_specs`).

    `specs` (`param_specs`; `ranks` a ("data", "model") or ("pod",
    "data", "model") mesh): the reference's prefill cells, the params
    cut by the training layout and the forward `MeshLayout`'s (Megatron
    tensor parallelism, the sequence cut between blocks): tokens are
    this rank's rows, kc / vc its rows and its KV heads (all of them
    when the heads do not split over "model"), the next tokens the
    argmax over every vocab shard."""
    if specs is not None:
        lay = MeshLayout(cfg, ranks, specs)

        def mesh_prefill_step(params, tokens):
            logits, kc, vc = prefill_mesh(params, tokens, cfg, lay)
            return (vocab_argmax(logits[:, 0], lay), kc.to(cfg.dtype),
                    vc.to(cfg.dtype))

        return mesh_prefill_step

    def prefill_step(params, tokens):
        logits, _, (kc, vc) = forward(params, tokens, cfg, collect_cache=True,
                                      ranks=ranks, dropped=dropped)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, kc.to(cfg.dtype), vc.to(cfg.dtype)

    return prefill_step


def prefill_mesh(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                 lay: MeshLayout):
    """The prompt through `lay`'s forward: (the last position's logits
    over this rank's vocab columns (B, 1, V_pad / model), kc, vc)."""
    x, _, (kc, vc) = _forward_trunk(params, tokens, cfg, collect_cache=True,
                                    lay=lay)
    last = x[:, -1:]
    if lay.seq:  # the last position is the last model rank's
        last = S.gather_dim(last, lay.mgroup, 1)[:, -1:]
    head = _head_weight(params, cfg, lay)
    return _mask_padding(last @ head.to(cfg.dtype), cfg, lay.vocab_start), \
        kc, vc


def vocab_argmax(logits: torch.Tensor, lay: MeshLayout) -> torch.Tensor:
    """The argmax (int32) over the whole vocab of logits cut by vocab over
    "model" (this rank's columns from `lay.vocab_start`): the first
    index of the largest value, as one argmax over the whole row."""
    vals, idx = torch.max(logits, dim=-1)
    idx = idx + lay.vocab_start
    if lay.model > 1:
        vals = S.gather_dim(vals[None], lay.mgroup, 0)
        idx = S.gather_dim(idx[None], lay.mgroup, 0)
        idx = idx.gather(0, torch.argmax(vals, dim=0)[None])[0]
    return idx.to(torch.int32)


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


def make_serve_step(cfg: TransformerConfig, ranks=None,
                    specs: "dict | None" = None,
                    seq_axes: tuple[str, ...] = (EXPERT_AXIS,)):
    """decode: (params, kc, vc, pos, tokens (B,)) -> (next (B,), kc, vc).
    kc/vc: (L, B, S_max, K, Dh), updated in place and returned; pos: host
    int, the current cache length. `ranks`: the serving layout, as
    `decode_logits`'.

    `specs` (`param_specs`): the reference's decode cells, the params cut
    by the training layout and the KV cache on its sequence dim over
    `seq_axes` ("model" when the batch is cut over the data axes, every
    axis for one sequence); see `decode_logits_mesh`."""
    if specs is not None:
        lay = MeshLayout(cfg, ranks, specs, seq_shard=False)

        def mesh_serve_step(params, kc, vc, pos, tokens):
            logits = decode_logits_mesh(params, kc, vc, pos, tokens, cfg, lay,
                                        seq_axes)
            return vocab_argmax(logits, lay), kc, vc

        return mesh_serve_step

    def serve_step(params, kc, vc, pos, tokens):
        logits = decode_logits(params, kc, vc, pos, tokens, cfg, ranks)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, kc, vc

    return serve_step


@torch.no_grad()
def decode_logits_mesh(params: dict, kc: torch.Tensor, vc: torch.Tensor,
                       pos: int, tokens: torch.Tensor, cfg: TransformerConfig,
                       lay: MeshLayout, seq_axes: tuple[str, ...]):
    """One decode step across ranks, the KV cache cut on its sequence dim:
    this rank's logits (B, V_pad / model) over its vocab columns.

    kc / vc (L, B, S_loc, K, Dh) hold every KV head of this rank's
    sequence slice (its flat index over `seq_axes`, outermost first);
    tokens are this rank's rows. Each layer projects the new token
    (tensor-parallel when the heads split over "model", then the queries
    and keys all-gathered over it; else on the gathered weights), writes
    its K / V on the rank whose slice holds `pos`, attends this rank's
    slice, and combines the ranks' (max, sum, weighted values) in
    float32 with all-reduces over `seq_axes`: the softmax over the
    whole cache. The FFN is `MeshLayout`'s, the MoE block the one-hot
    dispatch over this rank's experts, summed."""
    ranks = lay.ranks
    seq_axes = tuple(a for a in ranks.mesh.axis_names if a in seq_axes)
    seq_group = (ranks.group(seq_axes)
                 if ranks.axis_size(seq_axes) > 1 else None)
    lo = ranks.axis_index(seq_axes) * kc.shape[2]
    x = _embed(params, tokens, cfg, lay)[:, None, :]  # (B, 1, D)
    window = (cfg.sliding_window if cfg.sliding_window > 0
              else kc.shape[2] * ranks.axis_size(seq_axes) + 1)
    layers = _layers(params["blocks"], cfg.n_layers)
    for i, (p, is_global, theta) in enumerate(
            zip(layers, cfg.is_global_layers(), cfg.rope_thetas())):
        p = lay.layer_weights(p)
        h = L.rms_norm(x, p["ln1"])
        x = x + _decode_attn_mesh(p, h, kc[i], vc[i], pos, lo, cfg,
                                  is_global, window, theta, lay, seq_group)
        h2 = L.rms_norm(x, p["ln2"])
        ep_ranks = ranks if lay.model > 1 else None
        x = x + _ffn(p, h2, cfg, decode=True, ranks=ep_ranks, lay=lay)[0]
    x = L.rms_norm(x, params["ln_f"])
    head = _head_weight(params, cfg, lay)
    return _mask_padding(x @ head.to(cfg.dtype), cfg, lay.vocab_start)[:, 0]


def _decode_attn_mesh(p, x, kc, vc, pos, lo, cfg, is_global, window, theta,
                      lay: MeshLayout, seq_group):
    """One layer's decode attention on this rank (see
    `decode_logits_mesh`); kc / vc: (B, S_loc, K, Dh) views of this
    rank's slice of positions lo .. lo + S_loc - 1."""
    b, dh = x.shape[0], cfg.d_head
    ap = _attn_params(p) if lay.heads_tp else lay.whole_attn(p)
    n_q = lay.n_q if lay.heads_tp else cfg.n_heads
    q, k_new, v_new = L._project_qkv(ap, x, n_q, lay.n_kv, dh)
    qk = (p["attn"].get("qnorm"), p["attn"].get("knorm"))
    if qk[0] is not None:
        q = L.rms_norm(q, qk[0])
        k_new = L.rms_norm(k_new, qk[1])
    posb = torch.arange(pos, pos + 1, dtype=torch.int32,
                        device=x.device).expand(b, 1)
    q = L.rope(q, posb, theta)
    k_new = L.rope(k_new, posb, theta)
    if lay.heads_tp and lay.model > 1:
        q = S.gather_dim(q, lay.mgroup, 2)
        if lay.n_kv < cfg.n_kv_heads:
            k_new = S.gather_dim(k_new, lay.mgroup, 2)
            v_new = S.gather_dim(v_new, lay.mgroup, 2)
    s_loc = kc.shape[1]
    if lo <= pos < lo + s_loc:
        kc[:, pos - lo] = k_new[:, 0].to(kc.dtype)
        vc[:, pos - lo] = v_new[:, 0].to(vc.dtype)
    scores = L._grouped_scores(q * dh**-0.5, kc)  # (B, K, G, 1, S_loc)
    k_idx = lo + torch.arange(s_loc, dtype=torch.int32, device=x.device)
    mask = k_idx <= pos
    if not is_global:
        mask = mask & ((pos - k_idx) < window)
    scores = torch.where(mask, scores, L.NEG_INF)
    m = scores.amax(dim=-1)
    pr = torch.exp(scores - m[..., None])
    total = pr.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", pr, vc.float())
    if seq_group is not None:  # the softmax over every rank's slice
        top = D.all_reduce_max(m, seq_group)
        a = torch.exp(m - top)
        total = D.all_reduce_sum(total * a, seq_group)
        o = D.all_reduce_sum(o * a[..., None], seq_group)
    o = (o / total[..., None]).permute(0, 3, 1, 2, 4).reshape(
        b, 1, cfg.n_heads * dh)
    if not lay.heads_tp:
        return o.to(x.dtype) @ ap.wo
    width = lay.n_q * dh
    mine = o[..., lay.m * width:(lay.m + 1) * width]
    return lay.exit(mine.to(x.dtype) @ ap.wo)


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

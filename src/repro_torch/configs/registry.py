"""Arch × shape registry: every assigned (architecture, input-shape) cell
as a step and the shapes of its inputs, for the dry-run
(`launch/dryrun.py`) and for runs with real tensors.

`build_cell(arch, shape, mesh, multi_pod)` returns a Cell holding:
  fn            — the port's step for this mesh (eager, not compiled),
  inputs        — trees of `Leaf`s: each input's GLOBAL shape, dtype and
                  spec (`core/specs.py`'s form of a PartitionSpec), the
                  reference's ShapeDtypeStructs with their NamedShardings,
  donate        — the indices of the arguments whose buffers the step
                  replaces (params / opt state, or the caches), the
                  reference's donate_argnums; torch has no donation, so
                  it is a record only,
  model_flops   — 'useful' FLOPs (6·N_active·D etc.) for roofline ratios.
`Cell.local` gives a rank's blocks of the inputs as meta tensors (no
storage: a dry-run of a 67B model on one host), `Cell.materialize` the
same blocks as seeded real tensors.

`mesh` is a rank context (`core/ranks.py`; `launch/mesh.py` builds the
production ones, 16 x 16 and 2 x 16 x 16, on a fake process group) or a
ShardMesh of this process: one shard (the one-process steps), or, for
the `mapsq` join, every shard on this process's device.

Also here: the arch ids and config modules, the input shapes of each
family, the GNN shape bindings (`_gnn_dims`, `_gnn_cfg_for_shape`,
`_gnn_model_flops`), `DEFAULT_OPT`, the optimizer state's specs
(`zero1_spec`, `_opt_specs`), and the GNN and DeepFM train steps
(`gnn_train_step`, `deepfm_train_step`), on one process or across
ranks."""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable

import torch

from repro_torch import tree as TT
from repro_torch.core import specs as S
from repro_torch.core.distributed import ShardMesh
from repro_torch.optim.adamw import AdamWConfig, adamw_update

ARCHS: dict[str, str] = {
    # arch id -> config module
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "schnet": "repro_torch.configs.schnet",
    "graphcast": "repro_torch.configs.graphcast",
    "gat-cora": "repro_torch.configs.gat_cora",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "deepfm": "repro_torch.configs.deepfm",
    "mapsq": "repro_torch.configs.mapsq_lubm",
}

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232_965,
                         n_edges=114_615_892, d_feat=602, n_classes=41,
                         batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": dict(kind="full", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16, n_classes=1),
}
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_448),
    # n_candidates padded from 1,000,000 to the next multiple of 512 chips
}
SPARQL_SHAPES = {
    "join_1m": dict(kind="join", rows=1 << 20),
    "join_16m": dict(kind="join", rows=1 << 24),
}


def SHAPES_FOR(arch: str) -> dict[str, dict]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
            "sparql": SPARQL_SHAPES}[family_of(arch)]


def family_of(arch: str) -> str:
    return importlib.import_module(ARCHS[arch]).FAMILY


def archs_of(family: str) -> list[str]:
    """The arch ids of one family ("lm", "gnn" or "recsys"), sorted."""
    return sorted(a for a in ARCHS if family_of(a) == family)


def lm_layer_count(arch: str) -> int:
    return importlib.import_module(ARCHS[arch]).CONFIG.n_layers


DEFAULT_OPT = AdamWConfig()

# the reference's sharding helpers (`registry.py:110-128`), on the port's
# spec tuples: ZeRO-1's "data" cut of m and v (core/specs.py)
zero1_spec = S.zero1_spec
_opt_specs = S.opt_specs


def _all_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def _round_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_dims(arch: str, sh: dict, n_dev: int) -> dict:
    """Device-visible graph dims for a (gnn arch, shape) cell."""
    kind = sh["kind"]
    if kind == "minibatch":
        from repro_torch.models.gnn.sampler import block_capacity

        n, e = block_capacity(sh["batch_nodes"], list(sh["fanout"]))
    elif kind == "batched":
        n, e = sh["n_nodes"] * sh["batch"], sh["n_edges"] * sh["batch"]
    else:
        n, e = sh["n_nodes"], sh["n_edges"]
    e = _round_to(e, 512)  # edge dim shards over up to 512 chips
    n_graphs = sh.get("batch", 1)
    # Large graphs (>= 1M nodes) shard the node dim over every mesh axis
    # (padded to 512) and run node/edge activations in bf16: replicated
    # node tensors do not fit one chip at 2.45M nodes.
    shard_nodes = n >= 1_000_000
    if shard_nodes:
        n = _round_to(n, 512)
    d = dict(n=n, e=e, n_graphs=n_graphs, d_feat=sh["d_feat"],
             n_classes=sh["n_classes"], shard_nodes=shard_nodes)
    # graphcast mesh sizes derive from the shape
    d["n_mesh"] = _round_to(max(8, n // 4), 512 if shard_nodes else 1)
    d["e_mesh"] = _round_to(max(64, d["n_mesh"] * 7), 512)
    return d


def _gnn_module(arch: str):
    from repro_torch.models.gnn import gat, graphcast, meshgraphnet, schnet

    return {"gat-cora": gat, "schnet": schnet, "meshgraphnet": meshgraphnet,
            "graphcast": graphcast}[arch]


def _gnn_node_feat_dim(arch: str, cfg, dims: dict) -> int:
    if arch == "graphcast":
        return cfg.n_vars
    if arch == "schnet":
        return 1  # schnet reads species/positions from extras
    return dims["d_feat"]


def _gnn_cfg_for_shape(arch: str, cfg, dims: dict, multi_pod: bool = False):
    """Bind per-shape input dims into the arch config."""
    if arch == "gat-cora":
        cfg = dataclasses.replace(cfg, d_in=dims["d_feat"],
                                  n_classes=dims["n_classes"])
    if arch == "meshgraphnet":
        cfg = dataclasses.replace(cfg, d_node_in=dims["d_feat"])
    if dims.get("shard_nodes") and hasattr(cfg, "node_spec"):
        # node dim sharded over every axis, blocks remat'd, activations
        # bf16, gathers/scatters via the MapSQ shuffle, one-shot edge sets
        # streamed (graphcast only); `apply(ranks=)` over a mesh of those
        # axes runs it on a rank's shard (`data.graphs.shard_graph`), and
        # without ranks on the whole graph
        extra = {}
        if hasattr(cfg, "edge_stream_chunks"):
            extra["edge_stream_chunks"] = 16
        cfg = dataclasses.replace(cfg, node_spec=_all_axes(multi_pod),
                                  remat=True, compute_dtype=torch.bfloat16,
                                  shuffle_gather=True, **extra)
    return cfg


def _gnn_model_flops(arch: str, cfg, dims: dict) -> float:
    n, e = dims["n"], dims["e"]
    if arch == "gat-cora":
        d_in, h, d = cfg.d_in, cfg.n_heads, cfg.d_hidden
        fwd = 2 * n * d_in * h * d + 6 * e * h * d
        fwd += 2 * n * (h * d) * cfg.n_classes + 6 * e * cfg.n_classes
    elif arch == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        per = 2 * e * (r * d + d * d) + 2 * e * d + 6 * n * d * d
        fwd = cfg.n_interactions * per + 2 * n * d * d
    elif arch == "meshgraphnet":
        d = cfg.d_hidden
        per = 2 * e * (3 * d + d) * d + 2 * n * (2 * d + d) * d
        fwd = cfg.n_layers * per + 2 * n * cfg.d_node_in * d + 2 * e * 4 * d
    else:  # graphcast
        d = cfg.d_hidden
        nm, em = dims["n_mesh"], dims["e_mesh"]
        blk = lambda ee, nn: 2 * ee * (3 * d + d) * d + 2 * nn * (2 * d + d) * d
        fwd = (2 * n * cfg.n_vars * d + blk(e, nm)
               + cfg.n_layers * blk(em, nm) + blk(e, n)
               + 2 * n * d * cfg.n_vars)
    return 3.0 * fwd  # train = fwd + bwd(2x)


# ---------------------------------------------------------------------------
# Train steps (the reference's GNN and DeepFM cells)
# ---------------------------------------------------------------------------

def gnn_train_step(mod, cfg, opt_cfg: AdamWConfig = DEFAULT_OPT, ranks=None):
    """train_step(params, opt_state, graph) -> (params, opt_state, metrics):
    the gradient of `mod.loss_fn` over every param, then AdamW (metrics:
    grad_norm, lr). The params and the opt state are whole on every rank.

    `ranks` of more than one rank, with `cfg.node_spec` (MeshGraphNet or
    GraphCast; the graph this rank's shard from `data.graphs.
    shard_graph`): each rank's loss is its nodes' part of the global
    masked MSE (its squared errors over the global count), so the ranks'
    parts sum to the one-process loss. Without `node_spec` (the edge cut
    of `models/gnn/common.py`: this rank's slice of every edge set, every
    node table whole): every rank computes the one-process loss and
    seeds its backward with 1 / world of it. Either way a param's
    gradient is the sum of the ranks' and every rank takes the same
    AdamW step."""
    if ranks is None or ranks.world_size == 1:
        def train_step(params, opt_state, graph):
            grads = TT.grad(mod.loss_fn, params, graph, cfg, has_aux=False)
            return adamw_update(opt_cfg, grads, opt_state, params)

        return train_step

    group = ranks.group(tuple(ranks.mesh.axis_names))

    def node_loss(params, g):
        pred = mod.apply(params, g, cfg, ranks=ranks)
        err = torch.where(g.node_mask[:, None],
                          (pred - g.extras["targets"]) ** 2, 0.0)
        count = S.all_reduce_(g.node_mask.sum().reshape(1), group)
        return err.sum() / (count[0] * pred.shape[-1]).clamp_min(1)

    def edge_loss(params, g):
        return mod.loss_fn(params, g, cfg, ranks=ranks) / ranks.world_size

    loss = node_loss if getattr(cfg, "node_spec", ()) else edge_loss

    def train_step(params, opt_state, graph):
        grads = TT.grad(loss, params, graph, has_aux=False)
        grads = S.reduce_grads(grads, TT.map(lambda _: (), params), ranks)
        return adamw_update(opt_cfg, grads, opt_state, params)

    return train_step


def deepfm_train_step(cfg, opt_cfg: AdamWConfig = DEFAULT_OPT,
                      lookup_fn=None, ranks=None, meta_cap=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    for DeepFM: the gradient of `bce_loss` on batch {"ids" (B, F) int32,
    "labels" (B,) float32} (the tables get dense gradients, as
    `jax.grad` gives), then AdamW.

    `ranks` (a ("data", "model") mesh): the params are this rank's by
    `deepfm.param_specs` (`shard_params`: the table and fm_w row-cut over
    "model"), the opt state `adamw_init(params, param_specs, ranks)`'s (m
    and v by ZeRO-1), the batch this rank's rows (the global batch cut
    over every axis jointly, as the reference's lookup takes its ids),
    read through `make_sharded_lookup`. Each rank seeds its backward
    with 1 / world of its rows' mean loss; the tables' gradients come
    back through the lookup's exchanges to the rows' owners and are
    summed over "data", the dense MLP's and the bias's over every axis
    (the mean over the ranks' batches). `meta_cap`: the lookup's ids per
    owner on meta tensors (`make_sharded_lookup`)."""
    from repro_torch.models.recsys import deepfm as D

    specs = None
    if ranks is not None:
        lookup_fn = D.make_sharded_lookup(ranks, meta_cap)
        specs = D.param_specs(cfg)

    def loss(params, ids, labels):
        out = D.bce_loss(params, ids, labels, cfg, lookup_fn)
        return out if ranks is None else out / ranks.world_size

    def train_step(params, opt_state, batch):
        grads = TT.grad(loss, params, batch["ids"], batch["labels"],
                        has_aux=False)
        if ranks is not None:
            grads = S.reduce_grads(grads, specs, ranks)
        return adamw_update(opt_cfg, grads, opt_state, params, specs=specs,
                            ranks=ranks)

    return train_step


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    """One input of a cell: its global shape, dtype and spec, and how
    `Cell.materialize` fills it: "normal", "zeros", "ones", "bernoulli"
    (0 / 1 or False / True at even odds), "int" (uniform in [0, high)),
    "sorted" (the same, ascending in each block) or "param" / "opt" (the
    family's seeded init, or AdamW's zero state)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple = ()
    fill: str = "normal"
    high: int = 0


@dataclasses.dataclass(frozen=True)
class RelationLeaves:
    """A relation input: its schema and the Leafs of its cols and valid
    (a `core.relation.Relation` once made)."""
    schema: tuple[str, ...]
    cols: Leaf
    valid: Leaf


def _walk(tree, fn: Callable, path: str = ""):
    """`fn(leaf, path)` over the Leafs of an input tree, in its structure
    (dicts, lists, tuples, NamedTuples; a RelationLeaves becomes a
    Relation). Paths are the reference's `jax.tree_util.keystr`s:
    "[0]['blocks']['wq']", "[2].node_feat", "[0][0]" (a relation's
    cols)."""
    if isinstance(tree, Leaf):
        return fn(tree, path)
    if isinstance(tree, RelationLeaves):
        from repro_torch.core.relation import Relation

        return Relation(tree.schema, fn(tree.cols, path + "[0]"),
                        fn(tree.valid, path + "[1]"))
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), fn, f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    raise TypeError(f"{path}: {type(tree).__name__} in a cell's inputs")


def input_leaves(inputs) -> dict[str, Leaf]:
    """{path: Leaf} of every input of a cell."""
    out: dict[str, Leaf] = {}

    def keep(leaf, path):
        out[path] = leaf

    _walk(tuple(inputs), keep)
    return out


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    inputs: tuple
    donate: tuple[int, ...] = ()
    model_flops: float = 0.0
    note: str = ""
    mesh: Any = None  # the ShardMesh it was built for (`_shard_mesh`)
    # (gen, device) -> the whole params (the family's seeded init)
    make_params: "Callable | None" = dataclasses.field(default=None,
                                                       repr=False)
    # where a traced step's host-planned sizes come from on meta tensors
    host_sizes: str = ""

    def _ranks(self):
        """The rank context whose blocks the inputs are cut into (None:
        every block on this process, the global shapes)."""
        return self.mesh.ranks

    def block_shape(self, leaf: Leaf) -> tuple[int, ...]:
        ranks = self._ranks()
        if ranks is None:
            return tuple(leaf.shape)
        return S.local_shape(leaf.shape, leaf.spec, ranks)

    def local(self) -> tuple:
        """This rank's blocks of the inputs as meta tensors (no
        storage)."""
        return _walk(tuple(self.inputs), lambda leaf, _: torch.empty(
            self.block_shape(leaf), dtype=leaf.dtype, device="meta"))

    def materialize(self, seed: int, device) -> tuple:
        """This rank's blocks of the inputs as real tensors on `device`,
        drawn from `seed`: the params by the family's init (drawn whole,
        then cut), the opt state AdamW's zeros of them, every other leaf
        by its `fill`, each block from its own stream (so a leaf whole
        on several ranks is the same on each)."""
        device = torch.device(device)
        ranks = self._ranks()
        params = None
        if self.make_params is not None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = self.make_params(gen, device)
            pspecs = _walk(self.inputs[0], lambda leaf, _: leaf.spec)
            if ranks is not None:
                params = S.shard_tree(params, pspecs, ranks)
        leaves = list(input_leaves(self.inputs))

        def fill(leaf: Leaf, path: str):
            if leaf.fill == "param":
                return None  # replaced by the init below
            shape = self.block_shape(leaf)
            if leaf.fill == "opt":
                return torch.zeros(shape, dtype=leaf.dtype, device=device)
            block = 0
            if ranks is not None:
                axes = tuple(a for a in ranks.mesh.axis_names
                             if a in S.axes_of(leaf.spec))
                block = ranks.axis_index(axes) if axes else 0
            gen = torch.Generator(device=device).manual_seed(
                seed + 7919 * (1 + leaves.index(path)) + 104729 * block)
            return _fill(leaf, shape, gen, device)

        out = list(_walk(tuple(self.inputs), fill))
        if params is not None:
            out[0] = params
        return tuple(out)


def _fill(leaf: Leaf, shape, gen, device) -> torch.Tensor:
    kind, dt = leaf.fill, leaf.dtype
    if kind in ("int", "sorted"):
        x = torch.randint(0, max(1, leaf.high), shape, generator=gen,
                          dtype=torch.int64, device=device)
        if kind == "sorted":
            x = torch.sort(x.reshape(-1)).values.reshape(shape)
        return x.to(dt)
    if kind == "bernoulli":
        return (torch.rand(shape, generator=gen, device=device) < 0.5).to(dt)
    if kind == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    return torch.randn(shape, generator=gen, device=device).to(dt)


def _leaves_of(shapes_tree, specs_tree, fill: str, dtype=None):
    """A tree of Leafs from a tree of (meta) tensors and its spec tree
    (every leaf of `dtype` when given: AdamW's float32 moments)."""
    return S.map_leaves(lambda x, spec: Leaf(tuple(x.shape), dtype or x.dtype,
                                             tuple(spec), fill),
                        shapes_tree, specs_tree)


def _shard_mesh(mesh) -> ShardMesh:
    """A rank context's ShardMesh (its `ranks` the context), or the
    ShardMesh given: the one form the builders take."""
    return mesh if isinstance(mesh, ShardMesh) else mesh.mesh


def _mesh_sizes(mesh: ShardMesh) -> tuple[int, int, int]:
    """(n_devices, data_size (incl. pod), model_size)."""
    shape = mesh.shape
    model = shape.get("model", 1)
    data = shape.get("data", 1) * shape.get("pod", 1)
    return data * model, data, model


def _rank_context(mesh: ShardMesh):
    """The rank context of `mesh` when its steps run across ranks (more
    than one), else None (one process)."""
    if mesh.ranks is not None and mesh.ranks.world_size > 1:
        return mesh.ranks
    return None


def _one_process(mesh: ShardMesh, arch: str) -> None:
    """A family other than the join runs on one process only with one
    shard."""
    if mesh.ranks is None and mesh.n_shards > 1:
        raise ValueError(f"{arch}: a ShardMesh of {mesh.n_shards} local "
                         "shards; across shards the step needs a rank "
                         "context (launch/mesh.py)")


def _dp(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


# -- LM cells -----------------------------------------------------------------


def _build_lm(arch: str, cfg, shape_name: str, sh: dict, mesh, multi_pod):
    from repro_torch.models import transformer as T

    _one_process(mesh, arch)
    n_dev, data, model = _mesh_sizes(mesh)
    ranks = _rank_context(mesh)
    dp = _dp(multi_pod)
    pshapes = T.init_params(None, cfg, ep=model, device="meta")
    pspecs = T.param_specs(cfg, multi_pod, model)
    params = _leaves_of(pshapes, pspecs, "param")
    b, s = sh["batch"], sh["seq"]
    kind = sh["kind"]
    mflops = T.model_flops(cfg, kind, b, s, ep=model)

    def make_params(gen, device):
        return T.init_params(gen, cfg, ep=model)

    common = dict(model_flops=mflops, mesh=mesh, make_params=make_params)
    if kind == "train":
        ospecs = S.opt_specs(pspecs, pshapes, mesh.shape.get("data", 1))
        opt = {"m": _leaves_of(pshapes, ospecs["m"], "opt", torch.float32),
               "v": _leaves_of(pshapes, ospecs["v"], "opt", torch.float32),
               "step": Leaf((), torch.int32, (), "opt")}
        batch = {
            "tokens": Leaf((b, s), torch.int32, (dp, None), "int", cfg.vocab),
            "labels": Leaf((b, s), torch.int32, (dp, None), "int", cfg.vocab),
        }
        fn = T.make_train_step(cfg, DEFAULT_OPT, ranks=ranks)
        return Cell(arch, shape_name, kind, fn, (params, opt, batch),
                    donate=(0, 1), **common)

    if kind == "prefill":
        tokens = Leaf((b, s), torch.int32, (dp, None), "int", cfg.vocab)
        fn = (T.make_prefill_step(cfg) if ranks is None else
              T.make_prefill_step(cfg, ranks=ranks, specs=pspecs))
        return Cell(arch, shape_name, kind, fn, (params, tokens), **common)

    # decode: one new token against a seq-long KV cache
    cshape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
    seq_axes = _all_axes(multi_pod) if b == 1 else ("model",)
    if b == 1:
        cspec = (None, None, _all_axes(multi_pod), None, None)
    else:
        cspec = (None, dp, "model", None, None)
    kc = Leaf(cshape, cfg.dtype, cspec, "zeros")
    vc = Leaf(cshape, cfg.dtype, cspec, "zeros")
    pos = Leaf((), torch.int32, (), "int", s)
    tokens = Leaf((b,), torch.int32, (dp,) if b > 1 else (), "int", cfg.vocab)
    step = (T.make_serve_step(cfg) if ranks is None else
            T.make_serve_step(cfg, ranks, specs=pspecs, seq_axes=seq_axes))

    def serve_step(params, kc, vc, pos, tokens):
        # the port's position is a host int: read from a real tensor; a
        # meta trace takes the last slot (no shape and no FLOP count
        # depends on it)
        at = s - 1 if pos.device.type == "meta" else int(pos)
        return step(params, kc, vc, at, tokens)

    return Cell(arch, shape_name, kind, serve_step,
                (params, kc, vc, pos, tokens), donate=(1, 2),
                host_sizes="decode position: the last slot on meta", **common)


# -- GNN cells ----------------------------------------------------------------


def _gnn_extras_leaves(arch: str, dims: dict, espec, nspec, cfg) -> dict:
    f4, i4, b1 = torch.float32, torch.int32, torch.bool
    n, e = dims["n"], dims["e"]
    mspec = nspec  # mesh-node arrays follow the node sharding policy
    if arch == "gat-cora":
        return {
            "labels": Leaf((n,), i4, nspec, "int", dims["n_classes"]),
            "train_mask": Leaf((n,), b1, nspec, "bernoulli"),
        }
    if arch == "schnet":
        ng = dims["n_graphs"]
        return {
            "positions": Leaf((n, 3), f4, nspec),
            "species": Leaf((n,), i4, nspec, "int", cfg.max_z),
            "energy": Leaf((ng,), f4, ()),
            "graph_mask": Leaf((ng,), b1, (), "ones"),
        }
    if arch == "meshgraphnet":
        return {
            "edge_feat": Leaf((e, 4), f4, espec),
            "targets": Leaf((n, 3), f4, nspec),
        }
    if arch == "graphcast":
        nm, em = dims["n_mesh"], dims["e_mesh"]
        return {
            "mesh_feat_init": Leaf((nm, 1), f4, mspec),
            "g2m_feat": Leaf((e, 4), f4, espec),
            "mesh_edge_feat": Leaf((em, 4), f4, espec),
            "mesh_src": Leaf((em,), i4, espec, "int", nm),
            "mesh_dst": Leaf((em,), i4, espec, "sorted", nm),
            "mesh_mask": Leaf((em,), b1, espec, "ones"),
            "m2g_feat": Leaf((e, 4), f4, espec),
            "m2g_src": Leaf((e,), i4, espec, "int", nm),
            "m2g_dst": Leaf((e,), i4, espec, "sorted", n),
            "m2g_mask": Leaf((e,), b1, espec, "ones"),
            "targets": Leaf((n, 227), f4, nspec),
        }
    raise KeyError(arch)


def _uniform_routes(g, cfg, ranks):
    """The shuffle's routes of a node-sharded graph on meta tensors, at the
    uniform share: every rank asks each owner for, and serves each
    sender, an equal part of its edge slice (the reference sizes its
    buckets from the same share). Real graphs plan theirs from the
    graph (`data.graphs.shard_graph`)."""
    from repro_torch.models.gnn.distributed import (
        EdgeRoutes, GatherRoute, ScatterRoute,
    )
    from repro_torch.models.gnn.graphcast import _pick_chunks

    axes = tuple(ranks.mesh.axis_names)
    ndev, group = ranks.axis_size(axes), ranks.group(axes)
    meta = dict(device="meta", dtype=torch.int64)

    def share(c: int) -> list[int]:
        return [c // ndev + (1 if j < c % ndev else 0) for j in range(ndev)]

    def routes(e_loc: int, n_dst_loc: int, chunks: int) -> EdgeRoutes:
        c = e_loc // chunks
        gather = [GatherRoute(group, torch.empty(c, **meta),
                              torch.empty(c, **meta), share(c), share(c))
                  for _ in range(chunks)]
        scatter = [ScatterRoute(group, torch.empty(c, **meta),
                                torch.empty(c, **meta),
                                torch.empty(c, device="meta",
                                            dtype=torch.int32),
                                share(c), share(c), n_dst_loc)
                   for _ in range(chunks)]
        return EdgeRoutes(src=gather, dst=list(gather), scatter=scatter)

    stream = getattr(cfg, "edge_stream_chunks", 0)
    ex = g.extras
    if "mesh_src" not in ex:
        return {"edges": routes(g.src.shape[0], g.n_nodes, 1)}
    e_whole = g.src.shape[0] * ndev
    chunks = _pick_chunks(e_whole, stream) if stream else 1
    nm_loc = ex["mesh_feat_init"].shape[0]
    return {"g2m": routes(g.src.shape[0], nm_loc, chunks),
            "mesh": routes(ex["mesh_src"].shape[0], nm_loc, 1),
            "m2g": routes(ex["m2g_src"].shape[0], g.n_nodes, chunks)}


def _build_gnn(arch: str, cfg, shape_name: str, sh: dict, mesh, multi_pod):
    from repro_torch.models.gnn.common import GraphBatch

    _one_process(mesh, arch)
    n_dev, data, model = _mesh_sizes(mesh)
    ranks = _rank_context(mesh)
    dims = _gnn_dims(arch, sh, n_dev)
    cfg = _gnn_cfg_for_shape(arch, cfg, dims, multi_pod)
    mod = _gnn_module(arch)
    espec = (_all_axes(multi_pod),)  # edges shard over every axis
    # small graphs: node tables whole on every rank (the edge cut);
    # large graphs: node dim sharded over every axis
    nspec = (_all_axes(multi_pod),) if dims["shard_nodes"] else ()
    n, e = dims["n"], dims["e"]
    f4, i4, b1 = torch.float32, torch.int32, torch.bool
    # graphcast's GraphBatch edges are the grid -> mesh set
    n_dst = dims["n_mesh"] if arch == "graphcast" else n
    g = GraphBatch(
        node_feat=Leaf((n, _gnn_node_feat_dim(arch, cfg, dims)), f4, nspec),
        src=Leaf((e,), i4, espec, "int", n),
        dst=Leaf((e,), i4, espec, "sorted", n_dst),
        node_mask=Leaf((n,), b1, nspec, "ones"),
        edge_mask=Leaf((e,), b1, espec, "ones"),
        graph_ids=Leaf((n,), i4, nspec, "sorted", dims["n_graphs"]),
        extras=_gnn_extras_leaves(arch, dims, espec, nspec, cfg),
    )
    pshapes = mod.init_params(None, cfg, device="meta")
    pspecs = TT.map(lambda _: (), pshapes)
    params = _leaves_of(pshapes, pspecs, "param")
    opt = {"m": _leaves_of(pshapes, pspecs, "opt", torch.float32),
           "v": _leaves_of(pshapes, pspecs, "opt", torch.float32),
           "step": Leaf((), torch.int32, (), "opt")}
    step = gnn_train_step(mod, cfg, DEFAULT_OPT, ranks=ranks)
    node_sharded = ranks is not None and dims["shard_nodes"]
    model_shards = bool(getattr(cfg, "node_spec", ()))
    host_sizes = ""
    if node_sharded and model_shards:
        host_sizes = ("shuffle routes: the uniform share on meta "
                      "(real graphs: data.graphs.shard_graph)")
    node_extras = {k for k, v in g.extras.items() if v.spec == nspec}

    def train_step(params, opt_state, graph):
        if node_sharded and not model_shards:
            # a model without node sharding on node-cut inputs: every
            # node table gathered whole, then the edge cut (GSPMD's
            # all-gather for the reference)
            graph = _gather_nodes(graph, nspec, node_extras, ranks)
        elif node_sharded and "routes" not in graph.extras:
            if graph.src.device.type != "meta":
                raise ValueError("a node-sharded graph needs its shuffle "
                                 "routes: shard it with data.graphs."
                                 "shard_graph")
            graph = graph._replace(extras=dict(
                graph.extras, routes=_uniform_routes(graph, cfg, ranks)))
        return step(params, opt_state, graph)

    def make_params(gen, device):
        return mod.init_params(gen, cfg)

    return Cell(arch, shape_name, "train", train_step, (params, opt, g),
                donate=(0, 1), model_flops=_gnn_model_flops(arch, cfg, dims),
                mesh=mesh, make_params=make_params, host_sizes=host_sizes,
                note=("node tables gathered whole, then the edge cut"
                      if node_sharded and not model_shards else ""))


def _gather_nodes(g, nspec, node_extras, ranks):
    """Every node-cut leaf of a graph block (the node tables and the
    extras named in `node_extras`) whole on every rank."""
    def whole(x):
        return S.gather(x, nspec, ranks)

    return g._replace(
        node_feat=whole(g.node_feat), node_mask=whole(g.node_mask),
        graph_ids=whole(g.graph_ids),
        extras={k: whole(v) if k in node_extras else v
                for k, v in g.extras.items()})


# -- RecSys cells -------------------------------------------------------------


def _build_recsys(arch: str, cfg, shape_name: str, sh: dict, mesh, multi_pod):
    from repro_torch.models.recsys import deepfm as D

    _one_process(mesh, arch)
    n_dev, data, model = _mesh_sizes(mesh)
    ranks = _rank_context(mesh)
    dp = _dp(multi_pod)
    pshapes = D.init_params(None, cfg, device="meta")
    pspecs = D.param_specs(cfg)
    params = _leaves_of(pshapes, pspecs, "param")
    b = sh["batch"]
    kind = sh["kind"]
    ids_spec = (dp, None)
    rows = cfg.rows_per_field

    def lookup_cap(n_flat):  # the reference's per-owner bucket
        return max(64, _round_to(int(n_flat // n_dev // model *
                                     cfg.shuffle_capacity_factor) + 8, 8))

    mlp_flops = 2 * sum(
        a * b2 for a, b2 in zip(
            (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims,
            cfg.mlp_dims + (1,))
    )
    fm_flops = 4 * cfg.n_sparse * cfg.embed_dim
    fwd = b * (mlp_flops + fm_flops)

    def make_params(gen, device):
        return D.init_params(gen, cfg)

    def own_rows(x):
        """This rank's rows of a batch block cut over the data axes: the
        batch cut over every axis jointly, as the lookup takes it."""
        if ranks is None:
            return x
        n = x.shape[0] // model
        return x.narrow(0, ranks.axis_index("model") * n, n)

    common = dict(mesh=mesh, make_params=make_params)
    if ranks is not None:
        common["host_sizes"] = "lookup: the reference's per-owner capacity"
    if kind == "train":
        cap = lookup_cap(b * cfg.n_sparse)
        ospecs = S.opt_specs(pspecs, pshapes, mesh.shape.get("data", 1))
        opt = {"m": _leaves_of(pshapes, ospecs["m"], "opt", torch.float32),
               "v": _leaves_of(pshapes, ospecs["v"], "opt", torch.float32),
               "step": Leaf((), torch.int32, (), "opt")}
        batch = {
            "ids": Leaf((b, cfg.n_sparse), torch.int32, ids_spec, "int", rows),
            "labels": Leaf((b,), torch.float32, (dp,), "bernoulli"),
        }
        step = deepfm_train_step(cfg, DEFAULT_OPT, ranks=ranks, meta_cap=cap)

        def train_step(params, opt_state, batch):
            return step(params, opt_state,
                        {k: own_rows(v) for k, v in batch.items()})

        return Cell(arch, shape_name, kind, train_step, (params, opt, batch),
                    donate=(0, 1), model_flops=3.0 * fwd, **common)

    lookup = (None if ranks is None else
              D.make_sharded_lookup(ranks, lookup_cap(
                  (sh["n_candidates"] * cfg.n_item_fields)
                  if kind == "retrieval" else b * cfg.n_sparse)))
    if kind == "serve":
        def serve(params, ids):
            return torch.sigmoid(D.forward(params, own_rows(ids), cfg, lookup))

        ids = Leaf((b, cfg.n_sparse), torch.int32, ids_spec, "int", rows)
        return Cell(arch, shape_name, kind, serve, (params, ids),
                    model_flops=fwd, **common)

    # retrieval: 1 query x n_candidates batched dot
    nc = sh["n_candidates"]

    def retrieve(params, user_ids, cand_ids):
        return D.retrieval_scores(params, user_ids, cand_ids, cfg, lookup)

    user = Leaf((1, cfg.n_sparse), torch.int32, (), "int", rows)
    cand = Leaf((nc, cfg.n_item_fields), torch.int32,
                (_all_axes(multi_pod), None), "int", rows)
    r_flops = nc * (cfg.n_item_fields + 1) * cfg.embed_dim * 2
    return Cell(arch, shape_name, kind, retrieve, (params, user, cand),
                model_flops=r_flops, **common)


# -- SPARQL (the paper's own workload) cells ----------------------------------


def join_capacities(rows: int, mesh_shape: dict) -> tuple[int, int]:
    """(bucket_cap, join_cap) of a join of `rows` rows a side over a mesh
    of `mesh_shape` ({axis: size}), the reference's sizing: each
    destination's bucket at twice the expected rows per destination plus
    8, the join's output at 4x the rows a shard holds."""
    n_dev = math.prod(mesh_shape.values())
    rows_local = rows // n_dev
    max_axis = max(mesh_shape.values())
    bucket_cap = max(64, _round_to(int(rows_local / max_axis * 2) + 8, 8))
    join_cap = _round_to(rows_local * 4, 8)
    return bucket_cap, join_cap


def _build_sparql(arch: str, cfg, shape_name: str, sh: dict, mesh, multi_pod):
    from repro_torch.core.distributed import make_distributed_join_fn

    axes = _all_axes(multi_pod)
    rows = sh["rows"]
    bucket_cap, join_cap = join_capacities(rows, mesh.shape)
    fn = make_distributed_join_fn(mesh, axes, bucket_cap, join_cap,
                                  cfg.left_schema, cfg.right_schema)
    spec_rows = (axes, None)
    spec_valid = (axes,)

    def mk(schema) -> RelationLeaves:
        return RelationLeaves(
            tuple(schema),
            Leaf((rows, len(schema)), torch.int32, spec_rows, "int", rows),
            Leaf((rows,), torch.bool, spec_valid, "ones"))

    # 'useful work': the sort (n log n compares) + output materialization
    mflops = 2 * rows * math.log2(max(rows, 2)) + 3 * rows
    return Cell(arch, shape_name, "join", fn,
                (mk(cfg.left_schema), mk(cfg.right_schema)),
                model_flops=mflops, mesh=mesh,
                note=f"bucket_cap={bucket_cap} join_cap={join_cap}")


def build_cell(arch: str, shape: str, mesh, multi_pod: bool) -> Cell:
    """The (arch, shape) cell on `mesh` (see the module's docstring)."""
    mod = importlib.import_module(ARCHS[arch])
    cfg, fam = mod.CONFIG, mod.FAMILY
    sh = SHAPES_FOR(arch)[shape]
    builder = {"lm": _build_lm, "gnn": _build_gnn, "recsys": _build_recsys,
               "sparql": _build_sparql}[fam]
    return builder(arch, cfg, shape, sh, _shard_mesh(mesh), multi_pod)

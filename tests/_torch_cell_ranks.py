"""Rank programs of the cell layouts' tests (test_torch_mesh_pod.py,
test_torch_dist_layouts.py): each runs on every gloo rank that
`test_torch_dist_ranks.run_ranks` spawns (as "_torch_cell_ranks:<name>")
and returns numpy arrays, which the tests hold to the one-process port
(the `one_process_*` functions, run in the parent) and to the reference's
steps on the same inputs (`reference_cells`: tests/distributed/
cells_mesh_prog.py in a subprocess). Every input is drawn from a seed,
whole, in every process; each rank takes its part. This file imports
no JAX: the ranks import it."""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as TT
from repro_torch.core import specs as S
from repro_torch.data.tokens import data_rows
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init

import _torch_train_ranks as TRR

ROOT = pathlib.Path(__file__).resolve().parents[1]
POD_AXES = ("pod", "data", "model")
POD_CASES = [("dense", False, True), ("moe", False, True),
             ("dense", True, True)]
LAYOUT_MESHES = [(2, 2), (1, 4)]
PROMPT = (4, 16)  # (batch, tokens) of the prefill cases
S_MAX, P0, N_DECODE = 16, 8, 3  # the decode cases' cache, prompt, steps


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def reference_cells(part: str, tmp: pathlib.Path) -> dict:
    """The reference's outputs in the cells' layouts on these inputs
    (tests/distributed/cells_mesh_prog.py `part`, on forced host
    devices, in a process of its own): {key: numpy array}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        (str(ROOT / "src"), str(ROOT / "tests"))))
    env.pop("XLA_FLAGS", None)
    out = tmp / f"{part}.npz"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests/distributed/cells_mesh_prog.py"),
         part, str(out)], env=env, capture_output=True, text=True,
        timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def layout_config(kind: str):
    """The train tests' reduced LM configs (float32), and "h6": dense
    with 6 heads over 2 KV heads, which do not split over 4 model ranks
    (the attention then runs sequence-parallel)."""
    if kind == "h6":
        return dataclasses.replace(TRR.lm_config("dense"), n_heads=6,
                                   name="mesh-h6")
    return TRR.lm_config(kind)


# -- groups over ("pod", "data") and the multi-pod train step -------------------


def pod_steps(ranks, cfg) -> dict:
    """The train step on a ("pod", "data", "model") mesh with the
    multi-pod specs: metrics and the whole params after each step."""
    model = ranks.axis_size("model")
    specs = T.param_specs(cfg, True, model)
    params = T.shard_params(TRR.lm_params(cfg, model), ranks, specs)
    state = adamw_init(params, specs, ranks)
    step = T.make_train_step(cfg, TRR.OPT, ranks=ranks)
    dp = T.dp_axes(True)
    out = []
    for b in TRR.lm_batches(cfg):
        rows = {k: torch.from_numpy(v) for k, v in data_rows(
            b, ranks.axis_index(dp), ranks.axis_size(dp)).items()}
        params, state, m = step(params, state, rows)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "params": [_np(S.gather(p, sp, ranks)) for p, sp in zip(
                        TT.leaves(params), S.spec_leaves(specs, params))]})
    return out


def pod_prog(ranks) -> dict:
    groups = {}
    for axes in (("pod", "data"), ("pod", "model"), ("data", "model")):
        g = ranks.group(axes)
        groups[axes] = {"ranks": dist.get_process_group_ranks(g),
                        "rank_in_group": dist.get_rank(g),
                        "axis_index": ranks.axis_index(axes)}
    return {"groups": groups,
            "steps": {case: pod_steps(ranks, TRR.lm_config(*case))
                      for case in POD_CASES}}


# -- tensor-parallel prefill ----------------------------------------------------


def prompt_tokens(cfg) -> np.ndarray:
    return np.random.RandomState(7).randint(
        0, cfg.vocab, PROMPT).astype(np.int32)


def one_process_prefill(kind: str, model: int) -> dict:
    cfg = layout_config(kind)
    params = TRR.lm_params(cfg, model)
    tokens = torch.from_numpy(prompt_tokens(cfg))
    with torch.no_grad():
        logits, _, (kc, vc) = T.forward(params, tokens, cfg,
                                        collect_cache=True)
    return {"logits": _np(logits[:, -1]), "kc": _np(kc), "vc": _np(vc),
            "next": _np(torch.argmax(logits[:, -1], dim=-1))}


def kv_heads_held(lay, cfg) -> list[int]:
    """The global KV heads of this rank's prefill cache, in its order."""
    if not lay.heads_tp:
        return list(range(cfg.n_kv_heads))
    if lay.kv_keep is not None:
        return [lay.kv_keep]
    return list(range(lay.m * lay.n_kv, (lay.m + 1) * lay.n_kv))


def prefill_case(mesh, kind: str) -> dict:
    cfg = layout_config(kind)
    model = mesh.axis_size("model")
    specs = T.param_specs(cfg, False, model)
    params = T.shard_params(TRR.lm_params(cfg, model), mesh, specs)
    tokens = torch.from_numpy(prompt_tokens(cfg))
    rows = S.shard(tokens, (("data",), None), mesh)
    lay = T.MeshLayout(cfg, mesh, specs)
    with torch.no_grad():
        logits, kc, vc = T.prefill_mesh(params, rows, cfg, lay)
        nxt, kc2, vc2 = T.make_prefill_step(cfg, ranks=mesh, specs=specs)(
            params, rows)
    whole = S.gather_dim(logits[:, 0], lay.mgroup, 1) if lay.model > 1 \
        else logits[:, 0]
    return {"logits": _np(whole), "kc": _np(kc), "vc": _np(vc),
            "next": _np(nxt), "kc_step": _np(kc2),
            "heads": kv_heads_held(lay, cfg),
            "row0": mesh.axis_index("data") * rows.shape[0],
            "heads_tp": lay.heads_tp}


# -- decode with the KV cache cut on its sequence dim ---------------------------


def decode_inputs(cfg, batch: int, model: int):
    """The whole params, caches (L, B, S_MAX, K, Dh) holding a P0-token
    prompt, and the N_DECODE tokens to feed."""
    params = TRR.lm_params(cfg, model)
    rng = np.random.RandomState(8)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (batch, P0))
                              .astype(np.int32))
    with torch.no_grad():
        _, _, (kc, vc) = T.forward(params, prompt, cfg, collect_cache=True)
    pad = (0, 0, 0, 0, 0, S_MAX - P0)
    feed = rng.randint(0, cfg.vocab, (N_DECODE, batch)).astype(np.int32)
    return (params, torch.nn.functional.pad(kc, pad),
            torch.nn.functional.pad(vc, pad), feed)


def one_process_decode(kind: str, batch: int, model: int) -> dict:
    cfg = layout_config(kind)
    params, kc, vc, feed = decode_inputs(cfg, batch, model)
    logits = []
    for i, tok in enumerate(feed):
        logits.append(_np(T.decode_logits(params, kc, vc, P0 + i,
                                          torch.from_numpy(tok), cfg)))
    return {"logits": logits, "kc": _np(kc), "vc": _np(vc)}


def decode_case(mesh, kind: str, batch: int) -> dict:
    cfg = layout_config(kind)
    model = mesh.axis_size("model")
    specs = T.param_specs(cfg, False, model)
    params, kc, vc, feed = decode_inputs(cfg, batch, model)
    params = T.shard_params(params, mesh, specs)
    axes = tuple(mesh.mesh.axis_names)
    if batch > 1:
        seq_axes, cspec, tspec = ("model",), (None, ("data",), "model"), \
            (("data",),)
    else:
        seq_axes, cspec, tspec = axes, (None, None, axes), ()
    kc, vc = S.shard(kc, cspec, mesh), S.shard(vc, cspec, mesh)
    lay = T.MeshLayout(cfg, mesh, specs, seq_shard=False)
    step = T.make_serve_step(cfg, mesh, specs=specs, seq_axes=seq_axes)
    logits, nexts = [], []
    for i, tok in enumerate(feed):
        tok = S.shard(torch.from_numpy(tok), tspec, mesh)
        got = T.decode_logits_mesh(params, kc.clone(), vc.clone(), P0 + i,
                                   tok, cfg, lay, seq_axes)
        if lay.model > 1:
            got = S.gather_dim(got, lay.mgroup, 1)
        logits.append(_np(got))
        nxt, kc, vc = step(params, kc, vc, P0 + i, tok)
        nexts.append(_np(nxt))
    return {"logits": logits, "next": nexts, "kc": _np(kc), "vc": _np(vc),
            "cache_spec": cspec, "token_spec": tspec}


# -- the GNN train step in the edge cut -----------------------------------------

GNN_EDGE_CASES = (  # (arch, nodes, edges, edge slots, node features, dtype)
    ("gat-cora", 64, 500, 512, 12, "float32"),
    ("schnet", 64, 500, 512, 8, "float32"),
    ("meshgraphnet", 64, 500, 512, 8, "float32"),
    # float32 gradients of this reduced GraphCast are good to 1.9e-4
    # (relative L2 against float64, one process): held in float64
    ("graphcast", 256, 2000, 2048, 6, "float64"),
)


def gnn_edge_case(arch, n, e, e_cap, d_feat, dtype):
    """(module, config, params, whole graph) of an edge-cut case, its
    params and float arrays in `dtype`."""
    import importlib

    from repro_torch.configs import registry as TR
    from repro_torch.data.graphs import make_full_graph
    from repro_torch.launch.train import reduced_gnn

    cfg = reduced_gnn(arch, importlib.import_module(TR.ARCHS[arch]).CONFIG)
    mod = TR._gnn_module(arch)
    dt = getattr(torch, dtype)
    params = TT.map(lambda x: x.to(dt), mod.init_params(
        torch.Generator().manual_seed(2), cfg))
    g = make_full_graph(arch, n, e, e_cap, d_feat, 3, seed=1)

    def cast(a):
        return a.astype(dtype) if a.dtype.kind == "f" else a

    g = g._replace(node_feat=cast(g.node_feat),
                   extras={k: cast(v) for k, v in g.extras.items()})
    return mod, cfg, params, g


def one_process_gnn(case) -> dict:
    from repro_torch.configs import registry as TR
    from repro_torch.data.graphs import to_device

    mod, cfg, params, g = gnn_edge_case(*case)
    step = TR.gnn_train_step(mod, cfg, TRR.OPT)
    params, _, m = step(params, adamw_init(params), to_device(g, "cpu"))
    return {"params": [_np(p) for p in TT.leaves(params)],
            "grad_norm": float(m["grad_norm"])}


def gnn_edge_steps(mesh) -> dict:
    from repro_torch.configs import registry as TR
    from repro_torch.data.graphs import edge_cut_graph

    out = {}
    for case in GNN_EDGE_CASES:
        mod, cfg, params, g = gnn_edge_case(*case)
        step = TR.gnn_train_step(mod, cfg, TRR.OPT, ranks=mesh)
        params, _, m = step(params, adamw_init(params),
                            edge_cut_graph(g, mesh))
        out[case[0]] = {"params": [_np(p) for p in TT.leaves(params)],
                        "grad_norm": float(m["grad_norm"])}
    return out


PREFILL_KINDS = ("dense", "moe", "h6", "gqa1")
DECODE_CASES = (("dense", 4), ("moe", 4), ("h6", 1), ("gqa1", 1),
                ("dense", 1))


def layouts_prog(ranks) -> dict:
    out = {}
    for sizes in LAYOUT_MESHES:
        mesh = ranks.remesh(sizes, ("data", "model"))
        for kind in PREFILL_KINDS:
            out[("prefill", sizes, kind)] = prefill_case(mesh, kind)
        for kind, batch in DECODE_CASES:
            if batch % sizes[0] == 0:
                out[("decode", sizes, kind, batch)] = decode_case(
                    mesh, kind, batch)
        out[("gnn", sizes)] = gnn_edge_steps(mesh)
    return out


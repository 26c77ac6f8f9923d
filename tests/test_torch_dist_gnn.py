"""GNN node sharding across processes (gloo ranks on the CPU, float32) on
(2, 2) and (1, 4) meshes over ("data", "model"): the shuffle's node
gather and scatter (`models/gnn/distributed.py`), node-sharded
MeshGraphNet and GraphCast (plain and streamed; with the shuffle and
with the all-gather / reduce-scatter form), and the ogb_products
binding with a rank context.

The port does not copy the reference's capacity drop: on the graph where
the reference's shuffle drops messages (make_full_graph n = 64, e = 512,
ROADMAP Queue 3) the gathers equal `x[ids]` exactly and the scatter the
plain aggregate within 1e-6 (the same float32 sums, in the same order).
Each sender's run of dst ids arrives ascending, so one sorted segment sum
reduces them.

Models: the ranks' outputs, in rank order, equal the one-process port's
on the whole graph within rtol / atol 1e-5 (float32 sums in the chunked
or reduce-scattered order) and the JAX one-device `apply` within 1e-4
(test_torch_gnn.py's float32 bound); the ranks' param gradients of their
parts of the global masked MSE, summed, equal the one-process gradients
within a relative L2 error of 1e-5 (each leaf against its own norm) with
the shuffle, whose sums keep the one-process order, and 1e-3 in the
all-gather / reduce-scatter form (GATHER_GRAD_REL_L2 says why)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro_torch import tree as TT
from repro_torch.configs import registry as TR
from repro_torch.data.graphs import to_device
from repro_torch.launch.train import reduced_gnn
from repro_torch.models.gnn import common as TC

import _torch_model_ranks as MR
from test_torch_dist_ranks import run_ranks

MESHES = [(2, 2), (1, 4)]
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)
PORT_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_L2 = 1e-5
# the all-gather / reduce-scatter form sums a node's messages on each
# rank, then over the ranks: float32 rounding apart from the one-process
# order (outputs within 1e-5), and a ReLU whose input lies within that
# rounding of 0 takes the other side, which moves GraphCast's gradients
# by 2-4e-4 of their norm; a missing or doubled exchange moves them O(1)
GATHER_GRAD_REL_L2 = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {mesh: run_ranks(tmp_path_factory.mktemp("gnn"), 4,
                            "_torch_model_ranks:gnn_prog", axis_sizes=mesh,
                            axis_names=("data", "model"), timeout=300.0)
            for mesh in MESHES}


def _drop_case():
    from repro_torch.data.graphs import make_full_graph

    g = make_full_graph("meshgraphnet", 64, 512, 512, 8, 3, seed=0)
    rng = np.random.RandomState(5)
    return (g, rng.randn(64, 8).astype(np.float32),
            rng.randn(512, 8).astype(np.float32))


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_and_scatter_on_the_reference_drop_case(runs, mesh):
    g, x, msgs = _drop_case()
    ops = [r["node_ops"] for r in runs[mesh]]
    np.testing.assert_array_equal(np.concatenate([o["src"] for o in ops]),
                                  x[g.src])
    np.testing.assert_array_equal(np.concatenate([o["dst"] for o in ops]),
                                  x[g.dst])
    want = TC.aggregate(torch.from_numpy(msgs), torch.from_numpy(g.dst), 64,
                        torch.from_numpy(g.edge_mask)).numpy()
    np.testing.assert_allclose(np.concatenate([o["scatter"] for o in ops]),
                               want, **EXACT_TOL)


def test_the_reference_would_drop_on_that_graph():
    """The reference's bucket (`_cap_for`: 2x the uniform share) is below
    the load one dst-sorted edge slice sends one owner here."""
    g, _, _ = _drop_case()
    ndev, n_loc, e_loc = 4, 16, 128
    cap = ((int(e_loc / ndev * 2.0) + 15) // 8) * 8
    owner = (g.dst // n_loc).reshape(ndev, e_loc)
    load = max(np.bincount(o, minlength=ndev).max() for o in owner)
    assert load > cap


@pytest.mark.parametrize("mesh", MESHES)
def test_scatter_runs_arrive_dst_ascending(runs, mesh):
    for r, rec in enumerate(runs[mesh]):
        ops = rec["node_ops"]
        arrived = ops["arrived"] - r * 16
        runs_ = np.split(arrived, np.cumsum(ops["recv_counts"])[:-1])
        assert len(runs_) == 4 and sum(map(len, runs_)) > 0
        for run in runs_:
            assert (np.diff(run) >= 0).all()
        np.testing.assert_array_equal(arrived[ops["merge"]], ops["seg_ids"])
        assert (np.diff(ops["seg_ids"]) >= 0).all()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _one_process(arch, n, e, e_cap, chunks):
    """The one-process port's outputs and MSE gradients on the whole
    graph, and the JAX one-device apply, same weights."""
    cfg = MR.gnn_config(arch, chunks, False, sharded=False)
    mod = TR._gnn_module(arch)
    params = MR.gnn_params(arch, cfg)
    g_np = MR.gnn_graph(arch, n, e, e_cap)
    g = to_device(g_np, "cpu")
    with torch.no_grad():
        y = mod.apply(params, g, cfg).numpy()
    grads = TT.grad(mod.loss_fn, params, g, cfg, has_aux=False)
    rmod = RR._gnn_module(arch)
    rcfg = reduced_gnn(arch, importlib.import_module(RR.ARCHS[arch]).CONFIG)
    if arch == "graphcast":
        rcfg = dataclasses.replace(rcfg, edge_stream_chunks=chunks)
    ref = jax.jit(rmod.apply, static_argnums=2)(
        jax.tree.map(jnp.asarray, _numpy_tree(params)),
        jax.tree.map(jnp.asarray, g_np), rcfg)
    return y, [v.numpy() for v in TT.leaves(grads)], np.asarray(ref)


@pytest.fixture(scope="module")
def one_process():
    return {case: _one_process(*case[:4], case[4])
            for case in MR.GNN_CASES}


@pytest.mark.parametrize("case", MR.GNN_CASES, ids=lambda c: "-".join(
    map(str, (c[0], c[4], "shuffle" if c[5] else "gather"))))
@pytest.mark.parametrize("mesh", MESHES)
def test_node_sharded_models_match_one_process(runs, one_process, mesh,
                                               case):
    arch, _, _, _, chunks, shuffle = case
    got = [r["models"][(arch, chunks, shuffle)] for r in runs[mesh]]
    y, grads, ref = one_process[case]
    out = np.concatenate([g["y"] for g in got])
    np.testing.assert_allclose(out, y, **PORT_TOL)
    np.testing.assert_allclose(out, ref, **REF_TOL)
    bound = GRAD_REL_L2 if shuffle else GATHER_GRAD_REL_L2
    for i, want in enumerate(grads):
        total = sum(g["grads"][i] for g in got)
        err = np.linalg.norm(total - want) / np.linalg.norm(want)
        assert err <= bound, (i, err)


@pytest.mark.parametrize("mesh", MESHES)
def test_ogb_products_binds_to_the_ranks(runs, mesh):
    """The registry's ogb_products binding (nodes padded to 512, sharded
    over every axis, bf16, remat, the shuffle) against a rank context:
    its node_spec is every axis of the ranks' mesh, the group over it
    spans the 4 ranks in rank order, and every node and edge dim splits
    over them (`data.graphs.shard_graph` raises otherwise)."""
    for rec in runs[mesh]:
        for arch, dims in rec["ogb_products"].items():
            assert dims["shard_nodes"]
            assert dims["node_spec"] == ("data", "model")
            assert dims["split"] == 4 and dims["index"] == dims["rank"]
            assert dims["n"] == 2_449_408 and dims["e"] == 61_859_328
            for key in ("n", "e", "n_mesh", "e_mesh"):
                assert dims[key] % 4 == 0, (arch, key)
    dims = TR._gnn_dims("meshgraphnet", TR.GNN_SHAPES["ogb_products"], 4)
    cfg = TR._gnn_cfg_for_shape(
        "meshgraphnet",
        importlib.import_module(TR.ARCHS["meshgraphnet"]).CONFIG, dims)
    assert cfg.node_spec == ("data", "model") and cfg.shuffle_gather
    assert cfg.remat and cfg.compute_dtype == torch.bfloat16
    shapes = TR._gnn_module("meshgraphnet").init_params(None, cfg,
                                                        device="meta")
    assert shapes["enc_node"][0]["w"].shape == (100, 128)


@pytest.mark.parametrize("mesh", MESHES)
def test_node_group_is_every_axis_in_mesh_order(runs, mesh):
    """The node dim shards over every axis: their group is the world
    group in flat mesh order; a tuple of axes out of that order is
    refused, not taken as another group."""
    for rec in runs[mesh]:
        assert rec["node_group"] == {"world": True,
                                     "reversed_refused": True}

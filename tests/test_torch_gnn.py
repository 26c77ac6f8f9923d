"""The port's GNN forward (`repro_torch.core.segments`' segment ops,
`repro_torch.models.gnn.*`, `repro_torch.data.graphs`, the registry's GNN
bindings) against the reference's own functions on the same seeded numpy
inputs and the same weights (carried across by `params_from_numpy`), on
the CPU: the kernels' plain versions on the port's side, the Pallas
segment-sum kernel in interpret mode where the test names it.

Tolerances: the segment ops within rtol 1e-5 / atol 1e-5 (sums of a few
hundred float32 terms in another order); model outputs and losses in
float32 within rtol 1e-4 / atol 1e-4 (the LM port's reduced-arch
tolerance: a few hundred float32 products per dot, through up to 16
blocks); bfloat16 within rtol 5e-2 / atol 5e-2 (a few bf16 ulps, eps
2^-8, where the two frameworks round and accumulate apart). Data arrays
and weights are compared exactly.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.core import segments as RS
from repro.data import graphs as RG
from repro.kernels.segment_reduce import ops as RK
from repro_torch.configs import registry as TR
from repro_torch.core import segments as TS
from repro_torch.data import graphs as TG
from repro_torch.launch.train import reduced_gnn
from repro_torch.models.gnn import common as TC

SEG_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
GNN_ARCHS = ["gat-cora", "graphcast", "meshgraphnet", "schnet"]
D_FEAT = {"schnet": 1, "graphcast": 6, "gat-cora": 12, "meshgraphnet": 8}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


def _configs(arch, **changes):
    """(reference config, port config) of one arch, reduced as
    tests/test_archs_smoke.py reduces it."""
    ref = reduced_gnn(arch, importlib.import_module(RR.ARCHS[arch]).CONFIG)
    mine = reduced_gnn(arch, importlib.import_module(TR.ARCHS[arch]).CONFIG)
    jchanges = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
                for k, v in changes.items()}
    return (dataclasses.replace(ref, **jchanges),
            dataclasses.replace(mine, **changes))


def _ref(fn, static=2):
    """A reference function jitted with its config static (one compile in
    place of one per eager op)."""
    return jax.jit(fn, static_argnums=static)


def _both(g):
    """One numpy GraphBatch as the reference's jnp batch and the port's."""
    return jax.tree.map(jnp.asarray, g), TG.to_device(g, "cpu")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _params(arch, rcfg, cfg, seed=0):
    """Seeded weights (the port's init, drawn on the CPU) as numpy arrays,
    given to the reference as its pytree and carried into the port by
    params_from_numpy."""
    mod = TR._gnn_module(arch)
    tree = _numpy_tree(mod.init_params(torch.Generator().manual_seed(seed),
                                       cfg))
    return (jax.tree.map(jnp.asarray, tree),
            mod.params_from_numpy(tree, cfg, "cpu"))


def _graph(arch, n=40, e=90, e_cap=96, seed=0):
    """A reduced full graph, with padding edges (e < e_cap)."""
    return RG.make_full_graph(arch, n=n, e=e, e_cap=e_cap,
                              d_feat=D_FEAT[arch], n_classes=3, seed=seed)


# ---------------------------------------------------------------------------
# Segment ops
# ---------------------------------------------------------------------------

def _sorted_ids(rng, n, s, low=0, high=None):
    high = s if high is None else high
    return np.sort(rng.integers(low, high, n)).astype(np.int32)


SEG_CASES = {
    # name: (n, trailing shape, num_segments, id range)
    "uniform": (500, (16,), 64, None),
    "empty_segments": (300, (8,), 2000, (0, 40)),  # most segments empty
    "dropped_ids": (400, (8,), 50, (-3, 56)),  # below 0 and >= S drop
    "width_1": (257, (), 33, None),  # 1-D data, summed as (n, 1)
    "heads": (300, (4, 5), 70, None),  # (E, H, D): one call of width H*D
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_sorted_segment_sum_matches_reference(case):
    n, trail, s, rng_ids = SEG_CASES[case]
    rng = np.random.default_rng(len(case))
    lo, hi = rng_ids or (0, s)
    ids = _sorted_ids(rng, n, s, lo, hi)
    data = rng.standard_normal((n, *trail)).astype(np.float32)
    got = TS.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    want = RS.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), s)
    assert got.shape == want.shape == (s, *trail)
    _close(got, want, SEG_TOL)


def test_sorted_segment_sum_bf16():
    rng = np.random.default_rng(5)
    ids = _sorted_ids(rng, 600, 40)
    data = rng.standard_normal((600, 24)).astype(np.float32)
    got = TS.sorted_segment_sum(torch.from_numpy(data).bfloat16(),
                                torch.from_numpy(ids), 40)
    want = RS.sorted_segment_sum(jnp.asarray(data, jnp.bfloat16),
                                 jnp.asarray(ids), 40)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("n,d,s,lo,hi", [
    (512, 16, 128, 0, 128),
    (1000, 8, 4096, -5, 4100),  # the kernel's largest S; ids dropped
    (700, 1, 300, 0, 40),  # width 1, empty segments
])
def test_sorted_segment_sum_matches_pallas_kernel(n, d, s, lo, hi):
    rng = np.random.default_rng(n)
    ids = _sorted_ids(rng, n, s, lo, hi)
    data = rng.standard_normal((n, d)).astype(np.float32)
    got = TS.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    want = RK.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), s,
                                 use_kernel=True, interpret=True)
    _close(got, want, SEG_TOL)


def test_segment_max_and_plain_sum_match_jax():
    rng = np.random.default_rng(6)
    ids = rng.integers(-2, 45, 300).astype(np.int32)  # unsorted, dropped
    data = rng.standard_normal((300, 3)).astype(np.float32)
    t_data, t_ids = torch.from_numpy(data), torch.from_numpy(ids)
    got = TS.segment_max(t_data, t_ids, 60)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(data), jnp.asarray(ids),
                                          num_segments=60))
    assert np.isneginf(want).any()  # empty segments stay -inf
    np.testing.assert_array_equal(got.numpy(), want)
    _close(TS.segment_sum(t_data, t_ids, 60),
           jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=60), SEG_TOL)


SOFTMAX_CASES = {
    "heads": ((400, 4), 60, (0, 60), None),
    "one_column": ((300,), 50, (0, 50), None),
    "empty_segments": ((200, 2), 900, (0, 30), None),
    "dropped_ids": ((300, 3), 40, (-2, 44), None),
    "all_padding_segments": ((300, 2), 40, (0, 40), (10, 20)),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_segment_softmax_matches_reference(case):
    shape, s, (lo, hi), pad = SOFTMAX_CASES[case]
    rng = np.random.default_rng(len(case) + 10)
    ids = _sorted_ids(rng, shape[0], s, lo, hi)
    scores = (rng.standard_normal(shape) * 3).astype(np.float32)
    if pad:  # every row of segments [pad) at the padding score -1e30
        scores[(ids >= pad[0]) & (ids < pad[1])] = -1e30
    got = TS.segment_softmax(torch.from_numpy(scores), torch.from_numpy(ids), s)
    want = RS.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), s)
    _close(got, want, SEG_TOL)


# ---------------------------------------------------------------------------
# Data pipelines
# ---------------------------------------------------------------------------

def _assert_graph_equal(mine, ref):
    for name in TC.GraphBatch._fields[:-1]:
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert sorted(mine.extras) == sorted(ref.extras)
    for k, v in ref.extras.items():
        assert mine.extras[k].dtype == v.dtype, k
        np.testing.assert_array_equal(mine.extras[k], v, err_msg=k)


def _assert_dst_sorted(g):
    for k in ("dst", "mesh_dst", "m2g_dst"):
        arr = g.dst if k == "dst" else g.extras.get(k)
        if arr is not None:
            assert np.all(np.diff(arr) >= 0), k


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_make_full_graph_matches_reference(arch):
    kw = dict(n=50, e=120, e_cap=128, d_feat=D_FEAT[arch], n_classes=4,
              seed=3)
    mine = TG.make_full_graph(arch, **kw)
    _assert_graph_equal(mine, RG.make_full_graph(arch, **kw))
    _assert_dst_sorted(mine)


def test_make_molecule_batch_matches_reference():
    mine = TG.make_molecule_batch("schnet", 10, 24, 4, 1, seed=2)
    _assert_graph_equal(mine, RG.make_molecule_batch("schnet", 10, 24, 4, 1,
                                                     seed=2))
    assert np.all(np.diff(mine.graph_ids) >= 0)
    # each molecule's edges sorted by dst within its own node range
    assert np.all(np.diff(mine.dst.reshape(4, 24), axis=1) >= 0)


def test_minibatch_pipeline_matches_reference():
    kw = dict(n_nodes=500, n_edges=4000, d_feat=12, n_classes=3,
              batch_nodes=8, fanout=(3, 2), seed=4)
    mine, ref = TG.MinibatchPipeline("gat-cora", **kw), \
        RG.MinibatchPipeline("gat-cora", **kw)
    np.testing.assert_array_equal(mine.csr.indptr, ref.csr.indptr)
    np.testing.assert_array_equal(mine.csr.indices, ref.csr.indices)
    for _ in range(3):
        g = next(mine)
        _assert_graph_equal(g, next(ref))
        _assert_dst_sorted(g)
    assert mine.state_dict() == ref.state_dict() == {"seed": 4, "step": 3}


def test_to_device_keeps_types():
    g = TG.to_device(TG.make_full_graph("graphcast", 30, 60, 64, 6, 3), "cpu")
    assert g.src.dtype == g.dst.dtype == g.graph_ids.dtype == torch.int32
    assert g.extras["m2g_dst"].dtype == torch.int32
    assert g.edge_mask.dtype == torch.bool
    assert g.node_feat.dtype == torch.float32
    assert g.n_nodes == 30 and g.n_edges == 64


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_apply_and_loss_match_reference(arch):
    rcfg, cfg = _configs(arch)
    rparams, params = _params(arch, rcfg, cfg)
    rg, g = _both(_graph(arch))
    rmod, mod = RR._gnn_module(arch), TR._gnn_module(arch)
    with torch.inference_mode():
        out = mod.apply(params, g, cfg)
        loss = mod.loss_fn(params, g, cfg)
    want = _ref(rmod.apply)(rparams, rg, rcfg)
    assert out.shape == want.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    _close(out, want, F32_TOL)
    _close(loss, _ref(rmod.loss_fn)(rparams, rg, rcfg), F32_TOL)


def test_schnet_molecule_batch_matches_reference():
    rcfg, cfg = _configs("schnet")
    rparams, params = _params("schnet", rcfg, cfg, seed=1)
    rg, g = _both(RG.make_molecule_batch("schnet", 10, 24, 4, 1))
    with torch.inference_mode():
        energies = TR._gnn_module("schnet").apply(params, g, cfg)
        loss = TR._gnn_module("schnet").loss_fn(params, g, cfg)
    rmod = RR._gnn_module("schnet")
    assert energies.shape == (4,)
    _close(energies, _ref(rmod.apply)(rparams, rg, rcfg), F32_TOL)
    _close(loss, _ref(rmod.loss_fn)(rparams, rg, rcfg), F32_TOL)


def test_gat_on_a_sampled_minibatch_matches_reference():
    kw = dict(n_nodes=500, n_edges=4000, d_feat=12, n_classes=3,
              batch_nodes=8, fanout=(3, 2))
    rg, g = _both(RG.MinibatchPipeline("gat-cora", **kw).__next__())
    rcfg, cfg = _configs("gat-cora")
    rparams, params = _params("gat-cora", rcfg, cfg)
    with torch.inference_mode():
        loss = TR._gnn_module("gat-cora").loss_fn(params, g, cfg)
    _close(loss, _ref(RR._gnn_module("gat-cora").loss_fn)(rparams, rg, rcfg),
           F32_TOL)


def _graphcast_case(**changes):
    # 2048 edge slots: _pick_chunks cuts them into up to 4 chunks of 512
    rcfg, cfg = _configs("graphcast", **changes)
    rparams, params = _params("graphcast", rcfg, cfg, seed=2)
    rg, g = _both(RG.make_full_graph("graphcast", n=300, e=2000, e_cap=2048,
                                     d_feat=6, n_classes=3, seed=5))
    return rcfg, cfg, rparams, params, rg, g


@pytest.mark.parametrize("chunks", [0, 3, 4])
def test_graphcast_plain_and_streamed_match_reference(chunks):
    rcfg, cfg, rparams, params, rg, g = _graphcast_case(
        edge_stream_chunks=chunks)
    mod = TR._gnn_module("graphcast")
    with torch.inference_mode():
        out = mod.apply(params, g, cfg)
        loss = mod.loss_fn(params, g, cfg)
        plain = mod.apply(params, g, dataclasses.replace(
            cfg, edge_stream_chunks=0))
    rmod = RR._gnn_module("graphcast")
    _close(out, _ref(rmod.apply)(rparams, rg, rcfg), F32_TOL)
    _close(loss, _ref(rmod.loss_fn)(rparams, rg, rcfg), F32_TOL)
    _close(out, plain, F32_TOL)  # streaming changes the order of sums only


@pytest.mark.parametrize("chunks", [0, 4])
def test_graphcast_bf16_matches_reference(chunks):
    rcfg, cfg, rparams, params, rg, g = _graphcast_case(
        compute_dtype=torch.bfloat16, edge_stream_chunks=chunks)
    with torch.inference_mode():
        out = TR._gnn_module("graphcast").apply(params, g, cfg)
    want = _ref(RR._gnn_module("graphcast").apply)(rparams, rg, rcfg)
    assert out.dtype == torch.float32
    _close(out, want, BF16_TOL)


def test_meshgraphnet_bf16_matches_reference():
    rcfg, cfg = _configs("meshgraphnet", compute_dtype=torch.bfloat16)
    rparams, params = _params("meshgraphnet", rcfg, cfg)
    rg, g = _both(_graph("meshgraphnet"))
    with torch.inference_mode():
        out = TR._gnn_module("meshgraphnet").apply(params, g, cfg)
    _close(out, _ref(RR._gnn_module("meshgraphnet").apply)(rparams, rg, rcfg),
           BF16_TOL)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_params_from_numpy_round_trips_every_leaf(arch):
    """The reference's own init, carried across leaf for leaf."""
    rcfg, cfg = _configs(arch)
    rparams = _ref(RR._gnn_module(arch).init_params, 1)(
        jax.random.PRNGKey(0), rcfg)
    params = TR._gnn_module(arch).params_from_numpy(
        jax.tree.map(np.asarray, rparams), cfg, "cpu")
    want = dict(_leaves(jax.tree.map(np.asarray, rparams)))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        assert np.array_equal(got[k].numpy().view(np.uint32),
                              v.view(np.uint32)), k
    # the port's own init has the same structure and shapes
    own = dict(_leaves(TR._gnn_module(arch).init_params(
        torch.Generator().manual_seed(0), cfg)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}


def test_params_from_numpy_rejects_a_wrong_key_or_shape():
    rcfg, cfg = _configs("graphcast")
    tree = jax.tree.map(np.asarray, _ref(
        RR._gnn_module("graphcast").init_params, 1)(jax.random.PRNGKey(0), rcfg))
    mod = TR._gnn_module("graphcast")
    bad_key = dict(tree, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="keys"):
        mod.params_from_numpy(bad_key, cfg, "cpu")
    bad_shape = dict(tree, mesh_init=np.zeros((2, 16), np.float32))
    with pytest.raises(ValueError, match="shape"):
        mod.params_from_numpy(bad_shape, cfg, "cpu")
    short = dict(tree, processor=tree["processor"][:1])
    with pytest.raises(ValueError, match="list"):
        mod.params_from_numpy(short, cfg, "cpu")


# ---------------------------------------------------------------------------
# One device, configs and the registry's GNN bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,changes", [
    ("meshgraphnet", dict(node_spec=("data",))),
    ("meshgraphnet", dict(shuffle_gather=True)),
    ("graphcast", dict(node_spec=("data", "model"))),
    ("graphcast", dict(shuffle_gather=True, edge_stream_chunks=4)),
])
def test_node_sharding_and_shuffle_raise_on_one_device(arch, changes):
    """The one-shard rule (the reference on a (1, 1) mesh): without a rank
    context, node sharding and the shuffle run on the whole graph and
    equal the plain path exactly. (Across ranks:
    tests/test_torch_dist_gnn.py.) The name dates from when these paths
    raised on one device; it is kept so that the test's history stays
    one line."""
    _, cfg = _configs(arch, **changes)
    _, params = _params(arch, *_configs(arch))
    g = TG.to_device(_graph(arch), "cpu")
    plain = dataclasses.replace(cfg, node_spec=(), shuffle_gather=False)
    mod = TR._gnn_module(arch)
    with torch.inference_mode():
        got = mod.apply(params, g, cfg)
        want = mod.apply(params, g, plain)
        assert torch.equal(mod.apply(params, g, cfg, ranks=None), got)
    assert torch.equal(got, want)


def test_node_ops_raise_for_sharding_or_the_shuffle():
    """Without a rank context the node ops are the plain ones, whatever
    node_spec and shuffle say: x[ids] and the sorted aggregate, exactly.
    The name dates from when these ops raised for sharding or the
    shuffle; it is kept so that the test's history stays one line."""
    x = torch.randn(5, 3)
    ids = torch.tensor([0, 1, 1, 4], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True])
    torch.testing.assert_close(TC.take_nodes(x, ids, mask), x[ids])
    want = TC.aggregate(x[:4], ids, 5, mask)
    torch.testing.assert_close(TC.aggregate_nodes(x[:4], ids, 5, mask), want)
    for kw in (dict(node_spec=("data",)), dict(shuffle=True),
               dict(node_spec=("data", "model"), shuffle=True)):
        assert torch.equal(TC.take_nodes(x, ids, mask, **kw), x[ids])
        assert torch.equal(TC.aggregate_nodes(x[:4], ids, 5, mask, **kw),
                           want)
    assert TC.constrain_nodes(x, ("model",)) is x
    assert torch.equal(TC.aggregate(x[:4], ids, 5, mask,
                                    node_spec=("data",)), want)


def test_large_graph_binding_needs_several_devices():
    """ogb_products (>= 1M nodes) binds node sharding over every axis, the
    shuffle, bf16 and remat; on one device (no rank context) that config
    runs as one shard and equals the same config unsharded, bit for bit.
    Its ranks' part: tests/test_torch_dist_gnn.py. The name dates from
    when this binding raised on one device; it is kept so that the test's
    history stays one line."""
    dims = TR._gnn_dims("meshgraphnet", TR.GNN_SHAPES["ogb_products"], 1)
    cfg = TR._gnn_cfg_for_shape("meshgraphnet", _configs("meshgraphnet")[1],
                                dims)
    assert dims["shard_nodes"] and cfg.node_spec == ("data", "model")
    assert cfg.shuffle_gather and cfg.remat
    _, params = _params("meshgraphnet", *_configs("meshgraphnet"))
    g = TG.to_device(_graph("meshgraphnet"), "cpu")
    mod = TR._gnn_module("meshgraphnet")
    plain = dataclasses.replace(cfg, node_spec=(), shuffle_gather=False)
    with torch.inference_mode():
        got = mod.apply(params, g, cfg)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        assert torch.equal(got, mod.apply(params, g, plain))


DTYPE_NAMES = {jnp.float32: "float32", jnp.bfloat16: "bfloat16",
               torch.float32: "float32", torch.bfloat16: "bfloat16",
               None: None}


def _cfg_dict(cfg):
    """A config as a dict, its compute dtype (jnp or torch) by name."""
    d = dataclasses.asdict(cfg)
    if "compute_dtype" in d:
        d["compute_dtype"] = DTYPE_NAMES[d["compute_dtype"]]
    return d


@pytest.mark.parametrize("arch", GNN_ARCHS + ["deepfm"])
def test_configs_copy_the_reference(arch):
    ref = importlib.import_module(RR.ARCHS[arch])
    mine = importlib.import_module(TR.ARCHS[arch])
    assert mine.FAMILY == ref.FAMILY == TR.family_of(arch)
    assert _cfg_dict(mine.CONFIG) == _cfg_dict(ref.CONFIG)
    assert TR.SHAPES_FOR(arch) == RR.SHAPES_FOR(arch)


def test_family_shapes_copy_the_reference():
    assert TR.GNN_SHAPES == RR.GNN_SHAPES
    assert TR.RECSYS_SHAPES == RR.RECSYS_SHAPES
    assert TR.LM_SHAPES == RR.LM_SHAPES
    assert TR.archs_of("gnn") == sorted(GNN_ARCHS)
    assert TR.archs_of("recsys") == ["deepfm"]


@pytest.mark.parametrize("shape", sorted(RR.GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_bindings_match_the_reference(arch, shape):
    sh = RR.GNN_SHAPES[shape]
    dims = TR._gnn_dims(arch, sh, 1)
    assert dims == RR._gnn_dims(arch, sh, 1)
    mine = TR._gnn_cfg_for_shape(
        arch, importlib.import_module(TR.ARCHS[arch]).CONFIG, dims)
    ref = RR._gnn_cfg_for_shape(
        arch, importlib.import_module(RR.ARCHS[arch]).CONFIG, dims)
    assert _cfg_dict(mine) == _cfg_dict(ref)
    assert TR._gnn_node_feat_dim(arch, mine, dims) == \
        RR._gnn_node_feat_dim(arch, ref, dims)
    assert TR._gnn_model_flops(arch, mine, dims) == \
        RR._gnn_model_flops(arch, ref, dims)

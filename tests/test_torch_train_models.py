"""Gradients of the port's GNN and DeepFM losses, and the registry's train
steps, against the reference's (`jax.grad` of the same losses, the same
steps built from the reference's functions) on the same seeded numpy
graphs, ids and weights, on the CPU (the segment kernel's plain version
on the port's side); the backward of the kernel's autograd wrapper; and
the sorted segment sums a train step makes, counted.

Tolerances: each gradient leaf within a relative L2 error of 1e-4 (sums
of a few hundred float32 terms in another order, through up to 4
residual blocks) of its own norm; a leaf whose exact gradient (the
port's, in float64) is zero carries float32 rounding only and is held
to 1e-4 of 1e-4 of the whole gradient's norm (`_torch_trees`); losses within rtol 1e-4 / atol 1e-4; params after one
AdamW step within atol 1e-5 (an update is about lr times the sign of
m / sqrt(v), so a gradient that differs in its last bits moves a param
by at most a few ulps of lr); the sorted segment sum's gradient exactly
(a gather); segment_max's even split among tied maxima within 1 ulp
(torch divides by the tie count, JAX multiplies by its reciprocal).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_trees import assert_grads_close, float64_grad
from repro.configs import registry as RR
from repro.core import segments as RS
from repro.data import graphs as RG
from repro.models.recsys import deepfm as RD
from repro.optim import adamw as RA
from repro_torch import tree as TT
from repro_torch.configs import registry as TR
from repro_torch.core import segments as TS
from repro_torch.data import graphs as TG
from repro_torch.kernels.segment_reduce import kernel as seg_kernel
from repro_torch.kernels.segment_reduce import ops as seg_ops
from repro_torch.kernels.segment_reduce import ref as seg_ref
from repro_torch.launch.train import reduced_gnn
from repro_torch.models.recsys import deepfm as TD
from repro_torch.optim import adamw as TA

GRAD_REL_L2 = 1e-4
F32_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_ATOL = 1e-5
D_FEAT = {"schnet": 1, "graphcast": 6, "gat-cora": 12, "meshgraphnet": 8}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_grads_close(got_tree, want_tree, exact_tree=None):
    assert_grads_close("grads", TT.paths(got_tree), TT.leaves(got_tree),
                       [_np(w) for w in jax.tree.leaves(want_tree)],
                       None if exact_tree is None else TT.leaves(exact_tree),
                       GRAD_REL_L2)


def _numpy_tree(tree):
    return TT.map(lambda t: t.detach().numpy(), tree)


def _configs(arch, **changes):
    ref = reduced_gnn(arch, importlib.import_module(RR.ARCHS[arch]).CONFIG)
    mine = reduced_gnn(arch, importlib.import_module(TR.ARCHS[arch]).CONFIG)
    return (dataclasses.replace(ref, **changes),
            dataclasses.replace(mine, **changes))


def _params(arch, cfg, seed=0):
    """Seeded weights (the port's init) as the reference's pytree and the
    port's params."""
    mod = TR._gnn_module(arch)
    tree = _numpy_tree(mod.init_params(torch.Generator().manual_seed(seed),
                                       cfg))
    return (jax.tree.map(jnp.asarray, tree),
            mod.params_from_numpy(tree, cfg, "cpu"))


GNN_CASES = {
    # name: (arch, config changes, graph builder)
    "gat-cora": ("gat-cora", {}, "full"),
    "schnet": ("schnet", {}, "full"),
    "schnet_molecules": ("schnet", {}, "molecule"),
    "meshgraphnet": ("meshgraphnet", {}, "full"),
    "meshgraphnet_remat": ("meshgraphnet", dict(remat=True), "full"),
    "graphcast": ("graphcast", {}, "large"),
    "graphcast_remat": ("graphcast", dict(remat=True), "large"),
    "graphcast_streamed_remat": ("graphcast",
                                 dict(remat=True, edge_stream_chunks=4),
                                 "large"),
}


def _graph(arch, kind):
    if kind == "molecule":
        return RG.make_molecule_batch("schnet", 10, 24, 4, 1)
    if kind == "large":  # 2048 edge slots: up to 4 streamed chunks
        return RG.make_full_graph(arch, n=300, e=2000, e_cap=2048,
                                  d_feat=D_FEAT[arch], n_classes=3, seed=5)
    return RG.make_full_graph(arch, n=40, e=90, e_cap=96,
                              d_feat=D_FEAT[arch], n_classes=3, seed=1)


def _gnn_case(name):
    arch, changes, kind = GNN_CASES[name]
    rcfg, cfg = _configs(arch, **changes)
    rparams, params = _params(arch, cfg, seed=len(name))
    g_np = _graph(arch, kind)
    return (arch, rcfg, cfg, rparams, params,
            jax.tree.map(jnp.asarray, g_np), TG.to_device(g_np, "cpu"))


@pytest.mark.parametrize("name", sorted(GNN_CASES))
def test_gnn_loss_gradients_match_jax_grad(name):
    arch, rcfg, cfg, rparams, params, rg, g = _gnn_case(name)
    rmod, mod = RR._gnn_module(arch), TR._gnn_module(arch)
    want = jax.jit(jax.grad(rmod.loss_fn), static_argnums=2)(rparams, rg, rcfg)
    got = TT.grad(mod.loss_fn, params, g, cfg, has_aux=False)
    _assert_grads_close(got, want, float64_grad(mod.loss_fn, params, g,
                                                cfg=cfg))


@pytest.mark.parametrize("arch", ["graphcast", "meshgraphnet"])
def test_remat_gives_the_same_gradients(arch):
    """Rematerialized blocks rerun the same ops: the same gradients up to
    the order in which autograd sums the contributions to a tensor used
    twice (GraphCast's processor reads its node table as source and as
    destination), relative L2 1e-6."""
    _, cfg = _configs(arch)
    _, params = _params(arch, cfg)
    g = TG.to_device(_graph(arch, "large" if arch == "graphcast" else "full"),
                     "cpu")
    mod = TR._gnn_module(arch)
    plain = TT.grad(mod.loss_fn, params, g, cfg, has_aux=False)
    again = TT.grad(mod.loss_fn, params, g,
                    dataclasses.replace(cfg, remat=True), has_aux=False)
    for path, a, b in zip(TT.paths(plain), TT.leaves(plain), TT.leaves(again)):
        assert float((a - b).norm()) <= 1e-6 * float(a.norm()), path


def _ref_gnn_step(rmod, rcfg, opt):
    def step(params, opt_state, graph):
        grads = jax.grad(rmod.loss_fn)(params, graph, rcfg)
        return RA.adamw_update(opt, grads, opt_state, params)
    return jax.jit(step)


def _ref_opt(cfg: TA.AdamWConfig) -> RA.AdamWConfig:
    return RA.AdamWConfig(**dataclasses.asdict(cfg))


def _assert_params_close(got_tree, want_tree, atol=PARAM_ATOL):
    for path, g, w in zip(TT.paths(got_tree), TT.leaves(got_tree),
                          jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=0,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("name", ["gat-cora", "schnet", "meshgraphnet_remat",
                                  "graphcast_streamed_remat"])
def test_registry_gnn_train_step_matches_reference(name):
    arch, rcfg, cfg, rparams, params, rg, g = _gnn_case(name)
    opt = dataclasses.replace(TR.DEFAULT_OPT, warmup_steps=2)
    assert dataclasses.asdict(TR.DEFAULT_OPT) == \
        dataclasses.asdict(RR.DEFAULT_OPT)
    ref_step = _ref_gnn_step(RR._gnn_module(arch), rcfg, _ref_opt(opt))
    step = TR.gnn_train_step(TR._gnn_module(arch), cfg, opt)
    r_p, r_s = rparams, RA.adamw_init(rparams)
    p, s = params, TA.adamw_init(params)
    for _ in range(2):
        r_p, r_s, r_m = ref_step(r_p, r_s, rg)
        p, s, m = step(p, s, g)
    assert sorted(m) == sorted(r_m) == ["grad_norm", "lr"]
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(r_m[k]), **F32_TOL)
    assert int(s["step"]) == int(r_s["step"]) == 2
    _assert_params_close(p, r_p)


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------

DEEPFM = dict(n_sparse=6, embed_dim=4, mlp_dims=(16, 16), rows_per_field=50)


def _deepfm(seed=0):
    rcfg = RD.DeepFMConfig(**DEEPFM)
    cfg = TD.DeepFMConfig(**DEEPFM)
    tree = _numpy_tree(TD.init_params(torch.Generator().manual_seed(seed), cfg))
    tree["bias"] = np.float32(0.25)
    batch = _ctr_batch(cfg)
    return (rcfg, cfg, jax.tree.map(jnp.asarray, tree),
            TD.params_from_numpy(tree, cfg, "cpu"), batch)


def _ctr_batch(cfg, batch=32):
    from repro_torch.data.recsys import CTRPipeline

    return CTRPipeline(cfg.n_sparse, cfg.rows_per_field, batch).batch_at(0)


def test_deepfm_bce_gradient_matches_jax_grad():
    rcfg, cfg, rparams, params, batch = _deepfm()
    ids, labels = batch["ids"], batch["labels"]
    want = jax.jit(jax.grad(RD.bce_loss), static_argnums=3)(
        rparams, jnp.asarray(ids), jnp.asarray(labels), rcfg)
    got = TT.grad(TD.bce_loss, params, torch.from_numpy(ids),
                  torch.from_numpy(labels), cfg, has_aux=False)
    # a dense gradient of the whole table, zero on rows no id reached
    assert got["table"].shape == (cfg.total_rows, cfg.embed_dim)
    assert int((got["table"].abs().sum(1) > 0).sum()) == \
        int(np.unique(ids + np.arange(6) * 50).size)
    _assert_grads_close(got, want, float64_grad(
        TD.bce_loss, params, torch.from_numpy(ids), torch.from_numpy(labels),
        cfg=cfg))


def test_registry_deepfm_train_step_matches_reference():
    rcfg, cfg, rparams, params, batch = _deepfm(seed=3)
    opt = dataclasses.replace(TR.DEFAULT_OPT, warmup_steps=2)
    ropt = _ref_opt(opt)

    @jax.jit
    def ref_step(p, s, ids, labels):
        grads = jax.grad(RD.bce_loss)(p, ids, labels, rcfg)
        return RA.adamw_update(ropt, grads, s, p)

    step = TR.deepfm_train_step(cfg, opt)
    r_p, r_s = rparams, RA.adamw_init(rparams)
    p, s = params, TA.adamw_init(params)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        r_p, r_s, r_m = ref_step(r_p, r_s, jnp.asarray(batch["ids"]),
                                 jnp.asarray(batch["labels"]))
        p, s, m = step(p, s, t_batch)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(r_m[k]), **F32_TOL)
    _assert_params_close(p, r_p)


# ---------------------------------------------------------------------------
# The segment ops under autograd
# ---------------------------------------------------------------------------

def _seg_case(n=300, d=5, s=40, lo=-3, hi=44, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    data = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((s, d)).astype(np.float32)
    return ids, data, w


def test_sorted_segment_sum_gradient_matches_jax():
    """Dropped ids (below 0 and past num_segments) get no gradient."""
    ids, data, w = _seg_case()
    x = torch.from_numpy(data).requires_grad_(True)
    (TS.sorted_segment_sum(x, torch.from_numpy(ids), 40)
     * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda d: jnp.sum(RS.sorted_segment_sum(
        d, jnp.asarray(ids), 40) * w))(jnp.asarray(data))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert not x.grad[(ids < 0) | (ids >= 40)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_seg", [40, 0])
def test_kernel_wrapper_backward_is_the_plain_backward(monkeypatch, dtype,
                                                       n_seg):
    """The card's autograd wrapper, its kernel stood in for by the plain
    version (the kernel runs only on the card): the forward is the
    kernel's, the backward gathers grad_out rows by id, zero for dropped
    ids, in the data's dtype, as the plain version's own autograd."""
    monkeypatch.setattr(seg_kernel, "sorted_segment_sum_cuda",
                        seg_ref.sorted_segment_sum)
    ids, data, w = _seg_case(s=max(n_seg, 1))
    t_ids = torch.from_numpy(ids)
    x = torch.from_numpy(data).to(dtype).requires_grad_(True)
    y = torch.from_numpy(data).to(dtype).requires_grad_(True)
    out = seg_ops._SortedSegmentSum.apply(x, t_ids, n_seg)
    want = seg_ref.sorted_segment_sum(y, t_ids, n_seg)
    assert out.dtype == dtype and torch.equal(out, want)
    g = torch.from_numpy(w[:n_seg]).to(dtype)
    out.backward(g)
    want.backward(g)
    assert x.grad.dtype == dtype and torch.equal(x.grad, y.grad)


def test_segment_max_ties_split_the_gradient_as_jax():
    """Tied maxima of a segment share its gradient evenly in both."""
    ids = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 5, 7], np.int32)
    data = np.array([[3, 1], [3, 2], [1, 2], [-1, 0], [-1, 0], [4, 4],
                     [4, 1], [0, 4], [4, 4], [2, 2], [9, 9]], np.float32)
    w = np.arange(12, dtype=np.float32).reshape(6, 2) + 1
    x = torch.from_numpy(data).requires_grad_(True)
    out = TS.segment_max(x, torch.from_numpy(ids), 6)
    torch.where(torch.isfinite(out), out * torch.from_numpy(w), 0).sum().backward()

    def ref(d):
        m = jax.ops.segment_max(d, jnp.asarray(ids), num_segments=6)
        return jnp.sum(jnp.where(jnp.isfinite(m), m * w, 0))

    want = np.asarray(jax.grad(ref)(jnp.asarray(data)))
    assert want[0, 0] == want[1, 0] == w[0, 0] / 2  # a tie of two
    assert want[5, 0] == want[6, 0] == want[8, 0]  # and of three
    np.testing.assert_allclose(want[5, 0], w[2, 0] / 3, rtol=1e-6)
    # torch divides by the tie count, JAX multiplies by its reciprocal
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=2**-23, atol=0)


# ---------------------------------------------------------------------------
# Sorted segment sums per train step
# ---------------------------------------------------------------------------

def _forward_sums(arch, cfg, g) -> int:
    """Sorted segment sums in one forward: one per aggregation (GraphCast:
    g2m, each processor layer, m2g; streamed, one per edge chunk), and
    SchNet's per-graph readout."""
    from repro_torch.models.gnn.graphcast import _pick_chunks

    if arch in ("gat-cora", "meshgraphnet"):
        return cfg.n_layers
    if arch == "schnet":
        return cfg.n_interactions + 1
    if not cfg.edge_stream_chunks:
        return cfg.n_layers + 2
    return cfg.n_layers + sum(_pick_chunks(e, cfg.edge_stream_chunks)
                              for e in (g.n_edges, g.extras["m2g_src"].shape[0]))


@pytest.mark.parametrize("name", sorted(GNN_CASES))
def test_train_step_sums_once_per_aggregation_and_again_under_remat(
        monkeypatch, name):
    """A train step's sorted segment sums: the forward's, and every
    rematerialized block's again in the backward (every aggregation of
    MeshGraphNet and GraphCast lies in a block); the backward of a sum is
    a gather and sums nothing."""
    calls = []
    plain = seg_ops.sorted_segment_sum

    def counted(*a):
        calls.append(a[0].shape)
        return plain(*a)

    monkeypatch.setattr(seg_ops, "sorted_segment_sum", counted)
    arch, _, cfg, _, params, _, g = _gnn_case(name)
    step = TR.gnn_train_step(TR._gnn_module(arch), cfg)
    step(params, TA.adamw_init(params), g)
    fwd = _forward_sums(arch, cfg, g)
    assert len(calls) == fwd * (2 if getattr(cfg, "remat", False) else 1)


def test_deepfm_train_step_sums_twice(monkeypatch):
    calls = []
    plain = seg_ops.sorted_segment_sum
    monkeypatch.setattr(seg_ops, "sorted_segment_sum",
                        lambda *a: calls.append(1) or plain(*a))
    _, cfg, _, params, batch = _deepfm()
    TR.deepfm_train_step(cfg)(params, TA.adamw_init(params),
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(calls) == 2  # the table's bag and fm_w's

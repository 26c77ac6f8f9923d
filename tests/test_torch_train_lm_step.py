"""The port's LM train step (`repro_torch.models.transformer.
make_train_step`: gradients, micro-batch accumulation, AdamW) against the
reference's on the same seeded numpy tokens and weights, on the CPU, for
the reduced config of every LM arch in float32, with one and with two
micro-batches. The reference runs under a (1, 1) mesh with Auto axes, as
in `test_torch_lm_serve.py`.

Tolerances: loss, aux and grad norm within rtol 1e-4 / atol 1e-4; lr
within 2^-22 lr (the two cosines); params and the AdamW moments after the
step within atol 1e-5 (an update is about lr times the sign of
m / sqrt(v): a gradient that differs in its last bits moves a param by a
few ulps of lr at most, more only where the gradient is near zero, where
1e-5 is a third of the step's lr, 3e-5).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.core import compat
from repro.launch.train import reduced_lm as ref_reduced_lm
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch import tree as TT
from repro_torch.configs.registry import ARCHS, archs_of
from repro_torch.launch.train import reduced_lm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as TA

LM_ARCHS = archs_of("lm")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_reference(arch, n_micro, mesh):
    vocab = 500 if arch == "granite-moe-3b-a800m" else 512
    rcfg = dataclasses.replace(ref_reduced_lm(
        importlib.import_module(REF_ARCHS[arch]).CONFIG, vocab=vocab),
        dtype=jnp.float32)
    cfg = dataclasses.replace(reduced_lm(
        importlib.import_module(ARCHS[arch]).CONFIG, vocab=vocab),
        dtype=torch.float32)
    opt = TA.AdamWConfig(warmup_steps=10, total_steps=50)
    rparams = RT.init_params(jax.random.PRNGKey(2), rcfg, ep=1)
    params = T.params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    rng = np.random.default_rng(len(arch) + n_micro)
    toks = rng.integers(0, vocab, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    step = jax.jit(RT.make_train_step(
        rcfg, mesh, RA.AdamWConfig(**dataclasses.asdict(opt)), False,
        n_micro=n_micro))
    with compat.set_mesh(mesh):
        r_p, r_s, r_m = step(rparams, RA.adamw_init(rparams),
                             jax.tree.map(jnp.asarray, batch))
    p, s, m = T.make_train_step(cfg, opt, n_micro=n_micro)(
        params, TA.adamw_init(params),
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})

    assert sorted(m) == sorted(r_m) == ["aux", "grad_norm", "loss", "lr"]
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(r_m[k]), **F32_TOL)
    assert abs(float(m["lr"]) - float(r_m["lr"])) <= 2.0**-22 * opt.lr
    assert int(s["step"]) == int(r_s["step"]) == 1
    for tree, rtree in ((p, r_p), (s["m"], r_s["m"]), (s["v"], r_s["v"])):
        for path, g, w in zip(TT.paths(tree), TT.leaves(tree),
                              jax.tree.leaves(rtree)):
            assert g.dtype == torch.float32, path
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL, err_msg=path)


def test_micro_batches_average_the_gradient():
    """Two micro-batches of 2 give the mean of their gradients: the same
    update as one batch of 4 up to float32 sums, and the last micro-batch's
    loss."""
    cfg = dataclasses.replace(reduced_lm(importlib.import_module(
        ARCHS["gemma3-1b"]).CONFIG), dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 512, (4, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = TA.AdamWConfig(grad_compression_bf16=False)
    _, s1, m1 = T.make_train_step(cfg, opt)(params, TA.adamw_init(params), batch)
    _, s2, m2 = T.make_train_step(cfg, opt, n_micro=2)(
        params, TA.adamw_init(params), batch)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-5)
    last = T.make_loss_fn(cfg)(params, batch["tokens"][2:],
                               batch["labels"][2:])[1]
    assert float(m2["loss"]) == float(last["loss"].detach())
    for a, b in zip(TT.leaves(s1["m"]), TT.leaves(s2["m"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-8)

"""The port's DeepFM forward (`repro_torch.models.recsys.deepfm`) and CTR
pipeline (`repro_torch.data.recsys`) against the reference's on the same
seeded numpy ids and the same weights (carried across by
`params_from_numpy`), on the CPU (the segment kernel's plain version on
the port's side).

Tolerances: the embedding bag within rtol 1e-5 / atol 1e-5 (one row per
bag, or sums of a few rows: float32 adds in another order); logits,
losses and retrieval scores in float32 within rtol 1e-4 / atol 1e-4 (the
LM port's reduced-arch tolerance: dot products of a few hundred float32
terms). Pipeline arrays and weights are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import RECSYS_SHAPES as REF_SHAPES
from repro.data.recsys import CTRPipeline as RefPipeline
from repro.models.recsys import deepfm as RD
from repro_torch.configs.registry import RECSYS_SHAPES
from repro_torch.data.recsys import CTRPipeline
from repro_torch.models.recsys import deepfm as TD

BAG_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# test_archs_smoke.py's config, and one at DeepFM's published embedding
# width (10: rows of 40 bytes, not a multiple of 16) and field count
CONFIGS = {
    "smoke": RD.DeepFMConfig(n_sparse=6, embed_dim=4, mlp_dims=(16, 16),
                             rows_per_field=50),
    "published_widths": RD.DeepFMConfig(n_sparse=39, embed_dim=10,
                                        mlp_dims=(40, 40, 40),
                                        rows_per_field=300),
}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _port_cfg(rcfg):
    return TD.DeepFMConfig(**dataclasses.asdict(rcfg))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def _weights(rcfg, seed=0):
    """Seeded weights (the port's init on the CPU, with a non-zero bias)
    as numpy arrays: the reference's pytree and the port's params."""
    cfg = _port_cfg(rcfg)
    tree = _numpy_tree(TD.init_params(torch.Generator().manual_seed(seed),
                                      cfg))
    tree["bias"] = np.float32(0.25).reshape(())
    return (jax.tree.map(jnp.asarray, tree),
            TD.params_from_numpy(tree, cfg, "cpu"), cfg)


def _batch(rcfg, batch=32, step=0):
    return CTRPipeline(rcfg.n_sparse, rcfg.rows_per_field, batch).batch_at(step)


def test_pipeline_matches_reference():
    mine, ref = CTRPipeline(6, 50, 32, seed=3), RefPipeline(6, 50, 32, seed=3)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state_dict() == ref.state_dict() == {"seed": 3, "step": 3}
    mine.load_state_dict({"seed": 3, "step": 1})
    np.testing.assert_array_equal(next(mine)["ids"], ref.batch_at(1)["ids"])
    assert RECSYS_SHAPES == REF_SHAPES


@pytest.mark.parametrize("width", [1, 4, 10])
def test_embedding_bag_matches_reference(width):
    rng = np.random.default_rng(width)
    table = rng.standard_normal((200, width)).astype(np.float32)
    flat = rng.integers(-5, 210, 300).astype(np.int32)  # clipped at both ends
    bags = np.sort(rng.integers(0, 90, 300)).astype(np.int32)
    got = TD.embedding_bag_local(torch.from_numpy(table), torch.from_numpy(flat),
                                 torch.from_numpy(bags), 90)
    want = RD.embedding_bag_local(jnp.asarray(table), jnp.asarray(flat),
                                  jnp.asarray(bags), 90)
    assert got.shape == (90, width)
    _close(got, want, BAG_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_loss_match_reference(name):
    rcfg = CONFIGS[name]
    rparams, params, cfg = _weights(rcfg)
    b = _batch(rcfg)
    ids, labels = b["ids"], b["labels"]
    with torch.inference_mode():
        logits = TD.forward(params, torch.from_numpy(ids), cfg)
        loss = TD.bce_loss(params, torch.from_numpy(ids),
                           torch.from_numpy(labels), cfg)
        probs = torch.sigmoid(logits)  # the serve cell's output
    want = RD.forward(rparams, jnp.asarray(ids), rcfg)
    assert logits.shape == (32,) and logits.dtype == torch.float32
    _close(logits, want, F32_TOL)
    _close(probs, jax.nn.sigmoid(want), F32_TOL)
    _close(loss, RD.bce_loss(rparams, jnp.asarray(ids), jnp.asarray(labels),
                             rcfg), F32_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_retrieval_scores_match_reference(name):
    rcfg = CONFIGS[name]
    rparams, params, cfg = _weights(rcfg, seed=1)
    ids = _batch(rcfg, batch=64, step=2)["ids"]
    user = ids[:1]
    cand = ids[:, : rcfg.n_item_fields] % rcfg.rows_per_field
    with torch.inference_mode():
        got = TD.retrieval_scores(params, torch.from_numpy(user),
                                  torch.from_numpy(cand), cfg)
    want = RD.retrieval_scores(rparams, jnp.asarray(user), jnp.asarray(cand),
                               rcfg)
    assert got.shape == (64,)
    _close(got, want, F32_TOL)


def test_a_lookup_fn_of_the_callers_own_is_used():
    rcfg = CONFIGS["smoke"]
    _, params, cfg = _weights(rcfg)
    ids = torch.from_numpy(_batch(rcfg)["ids"])
    seen = []

    def lookup(tables, flat):  # a plain gather: the same rows as the bag
        seen.append((len(tables), flat.shape))
        return tuple(t[flat.long()] for t in tables)

    with torch.inference_mode():
        a = TD.forward(params, ids, cfg)
        b = TD.forward(params, ids, cfg, lookup_fn=lookup)
    assert seen == [(2, (32 * 6,))]  # the table and fm_w, in one call
    _close(b, a.numpy(), BAG_TOL)


def test_params_from_numpy_round_trips_and_rejects():
    rcfg = CONFIGS["smoke"]
    tree = jax.tree.map(np.asarray, RD.init_params(jax.random.PRNGKey(0), rcfg))
    cfg = _port_cfg(rcfg)
    params = TD.params_from_numpy(tree, cfg, "cpu")
    assert params["table"].shape == (rcfg.total_rows, rcfg.embed_dim)
    for k in ("table", "fm_w", "bias"):
        assert np.array_equal(params[k].numpy().view(np.uint32),
                              tree[k].view(np.uint32)), k
    for got, want in zip(params["mlp"], tree["mlp"]):
        for k in ("w", "b"):
            assert np.array_equal(got[k].numpy(), want[k]), k
    with pytest.raises(ValueError, match="keys"):
        TD.params_from_numpy({**tree, "extra": tree["bias"]}, cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        TD.params_from_numpy({**tree, "fm_w": tree["fm_w"][:-1]}, cfg, "cpu")
    with pytest.raises(ValueError, match="list"):
        TD.params_from_numpy({**tree, "mlp": tree["mlp"][:1]}, cfg, "cpu")

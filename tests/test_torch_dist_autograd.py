"""The differentiable collectives of core/distributed.py and the
row-sharded DeepFM lookup across processes (one shard per rank, gloo on
the CPU), on 2 ranks (a 1 x 2 mesh over ("data", "model")) and 4 (2 x 2).

Exchanges: the even exchange equals the one-process transpose
(`core.distributed.all_to_all` with every shard in one process), the
uneven one a numpy re-derivation; the cross-rank Jacobian of each
collective (every rank's outputs against every rank's inputs) in float64
by central differences equals the one its backward gives, within 1e-6
(EPS 1e-6 on values of order 1: the differences of linear maps are exact
to a few ulps of 1e-16 / 1e-6); the all-gather's backward is the
reduce-scatter (sum) of its gradient; the replicated gather's backward
(the slice of the gradient this rank's input made) is its cross-rank
Jacobian when every rank seeds the same output (the loss downstream the
same on every rank), within 1e-6.

Lookup: every rank's rows equal `table[ids]` bit for bit, also on a
skewed stream that overflows the reference's capacity; the table's
gradient (summed over the data axis, whose ranks hold the same rows)
equals the scatter-add within 1e-6 (float32 sums of a few terms in
another order); DeepFM's logits and retrieval scores equal the local
path's and the JAX forward's on the same weights within rtol / atol 1e-5
(the LM port's float32 tolerance at these widths)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models.recsys import deepfm as RD
from repro_torch.core import distributed as dj
from repro_torch.models.recsys import deepfm as TD

import _torch_model_ranks as MR
from test_torch_dist_ranks import run_ranks

MESHES = {2: (1, 2), 4: (2, 2)}
SEED = 0
JAC_TOL = dict(rtol=0, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_ranks(
                tmp_path_factory.mktemp(f"ag{world}"), world,
                "_torch_model_ranks:autograd_prog", SEED,
                axis_sizes=MESHES[world], axis_names=("data", "model"))
        return cache[world]

    return get


def _exchanges(runs, world):
    return [r["exchange"] for r in runs(world)]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_even_exchange_equals_the_one_process_transpose(runs, world):
    inp = MR.exchange_inputs(world, SEED)
    mesh = dj.make_mesh((world,), ("shards",))
    buf = torch.from_numpy(inp["even"]).reshape(world, world, 3, 2)
    want = dj.all_to_all(buf, mesh, "shards").reshape(world, world * 3, 2)
    for r, got in enumerate(_exchanges(runs, world)):
        np.testing.assert_array_equal(got["even"], want[r].numpy())
        np.testing.assert_array_equal(got["bool"], want[r].numpy() > 0)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_uneven_exchange_moves_the_split_rows(runs, world):
    inp = MR.exchange_inputs(world, SEED)
    splits = inp["splits"]
    for r, got in enumerate(_exchanges(runs, world)):
        want = [inp["uneven"][s][splits[s, :r].sum():splits[s, :r + 1].sum()]
                for s in range(world)]
        np.testing.assert_array_equal(got["uneven"], np.concatenate(want))


COLLECTIVES = ["exchange", "exchange_uneven", "all_gather_rows",
               "reduce_scatter_rows", "all_reduce_sum"]


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("world", sorted(MESHES))
def test_cross_rank_jacobians_match_the_backward(runs, world, name):
    """gradcheck across ranks: rows are outputs (rank s, element j),
    columns inputs (rank r, element i)."""
    per_rank = [got["jacobians"][name] for got in _exchanges(runs, world)]
    num = np.concatenate([n.T for n, _ in per_rank], axis=0)
    ana = np.concatenate([a for _, a in per_rank], axis=1)
    assert num.shape == ana.shape and num.any()
    np.testing.assert_allclose(ana, num, **JAC_TOL)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_all_gather_backward_is_the_reduce_scatter(runs, world):
    inp = MR.exchange_inputs(world, SEED)
    n = inp["even"].shape[1]
    for r, got in enumerate(_exchanges(runs, world)):
        want = inp["weights"][:, r * n:(r + 1) * n].sum(axis=0)
        np.testing.assert_allclose(got["gather_grad"], want, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_replicated_gather_gradient_is_its_cross_rank_jacobian(runs, world):
    inp = MR.exchange_inputs(world, SEED)
    want = np.concatenate(list(inp["rows"]), axis=1)
    per_rank = [got["replicated_jacobian"]
                for got in _exchanges(runs, world)]
    num = per_rank[0][0]
    for got, (n, _) in zip(_exchanges(runs, world), per_rank):
        np.testing.assert_array_equal(got["replicated"], want)
        np.testing.assert_array_equal(n, num)  # every rank saw one output
    ana = np.concatenate([a for _, a in per_rank], axis=1)
    assert num.shape == ana.T.shape and num.any()
    np.testing.assert_allclose(ana, num.T, **JAC_TOL)


def _lookups(runs, world):
    return [r["lookup"] for r in runs(world)]


@pytest.mark.parametrize("stream", ["ids", "skewed"])
@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_lookup_returns_table_rows_exactly(runs, world, stream):
    inp = MR.lookup_inputs(SEED)
    got = np.concatenate([r["rows" if stream == "ids" else "skewed"]
                          for r in _lookups(runs, world)])
    np.testing.assert_array_equal(got, inp["table"][inp[stream]])


def _reference_cap(cfg, n_flat: int, n_dev: int, model: int) -> int:
    """The reference's per-destination capacity of its sharded lookup
    (`_build_recsys`'s `make_lookup`): ids past it come back as zero rows
    there."""
    return max(64, RR._round_to(int(n_flat // n_dev // model
                                    * cfg.shuffle_capacity_factor) + 8, 8))


@pytest.mark.parametrize("world", sorted(MESHES))
def test_skewed_stream_overflows_the_reference_cap(world):
    """Every id of the skewed stream is owned by the first table rank, so
    that rank's load from each sender is the sender's whole slice, past
    the reference's capacity at DeepFM's capacity factor (1.5): the
    reference would return zero rows for the overflow; the port returns
    table[ids] (test_sharded_lookup_returns_table_rows_exactly)."""
    inp = MR.lookup_inputs(SEED)
    model = MESHES[world][1]
    n = inp["skewed"].shape[0]
    cap = _reference_cap(MR.deepfm_config(), n, world, model)
    owner = inp["skewed"] // (48 // model)
    loads = [int((part == 0).sum()) for part in np.split(owner, world)]
    assert min(loads) == n // world > cap


@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_lookup_gradient_is_the_scatter_add(runs, world):
    inp = MR.lookup_inputs(SEED)
    want = np.zeros_like(inp["table"])
    np.add.at(want, inp["ids"], inp["weights"])
    data, model = MESHES[world]
    grads = [r["table_grad"] for r in _lookups(runs, world)]
    # rank (d, m) holds table block m; the data axis's ranks hold it alike
    got = np.concatenate([sum(grads[d * model + m] for d in range(data))
                          for m in range(model)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _deepfm_tree(params):
    return {"table": params["table"].numpy(), "fm_w": params["fm_w"].numpy(),
            "bias": params["bias"].numpy(),
            "mlp": [{k: v.numpy() for k, v in p.items()}
                    for p in params["mlp"]]}


@pytest.mark.parametrize("world", sorted(MESHES))
def test_deepfm_with_the_sharded_lookup(runs, world):
    inp = MR.lookup_inputs(SEED)
    cfg = MR.deepfm_config()
    params = MR.deepfm_params()
    got = np.concatenate([r["logits"] for r in _lookups(runs, world)])
    scores = np.concatenate([r["scores"] for r in _lookups(runs, world)])
    batch, user, cand = (torch.from_numpy(inp[k])
                         for k in ("batch", "user", "cand"))
    with torch.no_grad():
        local = TD.forward(params, batch, cfg).numpy()
        local_scores = TD.retrieval_scores(params, user, cand, cfg).numpy()
    np.testing.assert_allclose(got, local, **F32_TOL)
    np.testing.assert_allclose(scores, local_scores, **F32_TOL)
    rcfg = RD.DeepFMConfig(n_sparse=6, embed_dim=4, mlp_dims=(16, 16),
                           rows_per_field=50)
    rp = jax.tree.map(jnp.asarray, _deepfm_tree(params))
    want = RD.forward(rp, jnp.asarray(inp["batch"]), rcfg)
    want_scores = RD.retrieval_scores(rp, jnp.asarray(inp["user"]),
                                      jnp.asarray(inp["cand"]), rcfg)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(scores, np.asarray(want_scores), **F32_TOL)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_deepfm_forward_routes_its_ids_once(runs, world):
    """The table and fm_w are read in one route a forward: one count
    exchange, one id exchange and one exchange of both tables' rows (the
    rows of width embed_dim + 1)."""
    cfg = MR.deepfm_config()
    for r in _lookups(runs, world):
        assert r["forward_exchanges"] == [1, 1, cfg.embed_dim + 1]


def test_param_specs_follow_the_reference():
    cfg = MR.deepfm_config()
    specs = TD.param_specs(cfg)
    ref = RD.param_specs(RD.DeepFMConfig(n_sparse=6, embed_dim=4,
                                         mlp_dims=(16, 16),
                                         rows_per_field=50))
    assert specs["table"] == tuple(ref["table"])
    assert specs["fm_w"] == tuple(ref["fm_w"])
    assert specs["bias"] == tuple(ref["bias"])
    assert [{k: tuple(v) for k, v in p.items()} for p in ref["mlp"]] == \
        specs["mlp"]

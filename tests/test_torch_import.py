"""The PyTorch port stands alone: importing every module of `repro_torch`
loads neither JAX, nor `ml_dtypes`, nor any module of the JAX package."""
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (test files import both frameworks)
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list[str]:
    root = SRC / "repro_torch"
    mods = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_reference():
    mods = _port_modules()
    for m in (
        "repro_torch.sparql.engine",
        "repro_torch.kernels.bitonic_sort.ops",
        "repro_torch.kernels.segment_reduce.ops",
        "repro_torch.serve.batcher",
        "repro_torch.serve.decode",
        "repro_torch.serve.sparql_server",
        "repro_torch.launch.serve",
        "repro_torch.obs.metrics",
        "repro_torch.obs.trace",
        "repro_torch.core.distributed",
        "repro_torch.core.dist_executor",
        "repro_torch.sparql.sharded_store",
        "repro_torch.core.ranks",
        "repro_torch.configs.registry",
        "repro_torch.configs.gemma3_1b",
        "repro_torch.configs.qwen2_5_32b",
        "repro_torch.configs.deepseek_67b",
        "repro_torch.configs.olmoe_1b_7b",
        "repro_torch.configs.granite_moe_3b_a800m",
        "repro_torch.models.layers",
        "repro_torch.models.moe",
        "repro_torch.models.transformer",
        "repro_torch.launch.train",
        "repro_torch.models.gnn.common",
        "repro_torch.models.gnn.gat",
        "repro_torch.models.gnn.schnet",
        "repro_torch.models.gnn.meshgraphnet",
        "repro_torch.models.gnn.graphcast",
        "repro_torch.models.gnn.sampler",
        "repro_torch.models.gnn.distributed",
        "repro_torch.models.recsys.deepfm",
        "repro_torch.data.graphs",
        "repro_torch.data.recsys",
        "repro_torch.configs.gat_cora",
        "repro_torch.configs.schnet",
        "repro_torch.configs.meshgraphnet",
        "repro_torch.configs.graphcast",
        "repro_torch.configs.deepfm",
        "repro_torch.tree",
        "repro_torch.optim",
        "repro_torch.optim.adamw",
        "repro_torch.data.tokens",
        "repro_torch.checkpoint",
        "repro_torch.checkpoint.manager",
        "repro_torch.train",
        "repro_torch.train.trainer",
        "repro_torch.configs.mapsq_lubm",
        "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun",
        "repro_torch.obs.collectives",
        "repro_torch.obs.costs",
    ):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes')\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_server_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        serve.serve_sparql(scale=1, n_queries=1)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("the server launcher ran without a card")


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine

    store = lubm.generate(scale=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        QueryEngine(store)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("QueryEngine() ran without a card")
    assert QueryEngine(store, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu").type == "cpu"


def test_graphs_and_weights_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.data import graphs
    from repro_torch.models.gnn import gat
    from repro_torch.models.recsys import deepfm

    g = graphs.make_full_graph("gat-cora", 20, 40, 48, 12, 3)
    cfg = gat.GATConfig(d_in=12, n_classes=3)
    tree = {"layers": [{k: v.numpy() for k, v in layer.items()} for layer in
                       gat.init_params(torch.Generator(), cfg)["layers"]]}
    dcfg = deepfm.DeepFMConfig(n_sparse=2, embed_dim=4, mlp_dims=(8,),
                               rows_per_field=10)
    dtree = deepfm.init_params(torch.Generator(), dcfg)
    dtree = {"table": dtree["table"].numpy(), "fm_w": dtree["fm_w"].numpy(),
             "bias": dtree["bias"].numpy(),
             "mlp": [{k: v.numpy() for k, v in p.items()}
                     for p in dtree["mlp"]]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: graphs.to_device(g),
                 lambda: gat.params_from_numpy(tree, cfg),
                 lambda: deepfm.params_from_numpy(dtree, dcfg)):
        try:
            call()
        except RuntimeError as e:
            assert "device='cpu'" in str(e)
        else:
            raise AssertionError("placed on the CPU without being asked")
    assert graphs.to_device(g, "cpu").src.device.type == "cpu"
    assert gat.params_from_numpy(tree, cfg, "cpu")["layers"][0]["w"].shape == \
        (12, 8, 8)

"""The dry-run (`repro_torch.launch.dryrun`) on a fake world, and the
kernel ops' shape rules that let it trace on meta tensors.

- `run_cell` of one cell of each family (gemma3-1b long_500k, gat-cora
  full_graph_sm, deepfm serve_p99, mapsq join_1m) on the 16 x 16 and
  2 x 16 x 16 meshes (a subprocess: one fake process group a process)
  writes a record with every field of the reference's `run_cell` record
  (`src/repro/launch/dryrun.py:182-219`) and the port's own (t_trace_s,
  the H100 constants and their source, the fields with no counterpart);
- mapsq join_1m's collective bytes equal the hand count: on each mesh
  axis, for each side, one all-to-all of axis_size x bucket_cap x
  (n_cols + 1) x 4 bytes (the reference ships the valid flags in a
  second all-to-all; the port packs them into the rows as one more
  int32 column);
- at a one-rank mesh, the meta trace of a reduced LM train step (the
  train tests' MoE config) and of reduced GNN train steps (GAT,
  MeshGraphNet, GraphCast) counts exactly the FLOPs and the bytes that
  the same step counts on real CPU tensors;
- every kernel op's shape rule (pair_expand, match_layout, sort_ranks,
  cumsum_i32, and the meta branches of sorted_segment_sum and
  sort_pairs) gives the plain version's output shapes and dtypes, also
  under vmap, and a meta tensor never runs the plain version.
"""
import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax  # noqa: F401  (test files import both frameworks)
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import dryrun

import _torch_train_ranks as TRR

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [("gemma3-1b", "long_500k"), ("gat-cora", "full_graph_sm"),
         ("deepfm", "serve_p99"), ("mapsq", "join_1m")]
# the reference's record (src/repro/launch/dryrun.py:182-219)
REF_FIELDS = {"arch", "shape", "kind", "mesh", "chips", "t_lower_s",
              "t_compile_s", "flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "memory", "model_flops_global",
              "layer_probe", "t_compute", "t_memory", "t_memory_io",
              "t_collective", "bottleneck", "useful_flops_ratio"}
REF_MEMORY = {"temp_bytes", "argument_bytes", "output_bytes", "alias_bytes"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    code = ("from repro_torch.launch import dryrun\n"
            f"for a, s in {CELLS!r}:\n"
            f"    assert dryrun.main(['--arch', a, '--shape', s, '--mesh', "
            f"'both', '--out', {str(out)!r}]) == 0\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return {(p.stem.split("__")[0], p.stem.split("__")[1],
             p.stem.split("__")[2]): json.loads(p.read_text())
            for p in out.glob("*.json")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_record_has_the_reference_fields(records, arch, shape, mesh):
    rec = records[(arch, shape, mesh)]
    assert REF_FIELDS <= set(rec)
    assert REF_MEMORY <= set(rec["memory"])
    assert {"t_trace_s", "constants", "no_counterpart"} <= set(rec)
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert rec["constants"]["peak_flops_bf16"] == 989.4e12
    assert rec["constants"]["hbm_bytes_per_s"] == 3.35e12
    assert "datasheet" in rec["constants"]["source"]
    for k in ("total", "link_bytes", "counts"):
        assert k in rec["collective_bytes_per_device"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["t_lower_s"] is None and rec["layer_probe"] is None


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_mapsq_collective_bytes_are_the_hand_count(records, mesh):
    rec = records[("mapsq", "join_1m", mesh)]
    shape = ({"pod": 2, "data": 16, "model": 16} if mesh == "multi"
             else {"data": 16, "model": 16})
    bucket_cap, _ = R.join_capacities(1 << 20, shape)
    n_cols = 2
    want = sum(2 * size * bucket_cap * (n_cols + 1) * 4
               for size in shape.values())
    coll = rec["collective_bytes_per_device"]
    assert coll["all-to-all"] == coll["total"] == want
    assert coll["counts"] == {"all-to-all": 2 * len(shape)}


def _one_rank_cells():
    mesh = make_mesh((1, 1), ("data", "model"))
    lm = R._build_lm("olmoe-1b-7b", TRR.lm_config("moe"), "train_small",
                     dict(kind="train", seq=32, batch=2), mesh, False)
    cells = [lm]
    for arch in ("gat-cora", "meshgraphnet", "graphcast"):
        from repro_torch.launch.train import reduced_gnn

        cfg = reduced_gnn(arch, R.importlib.import_module(
            R.ARCHS[arch]).CONFIG)
        if arch == "graphcast":  # the cell's targets are 227 wide
            cfg = R.dataclasses.replace(cfg, n_vars=227)
        sh = dict(kind="full", n_nodes=64, n_edges=500, d_feat=12,
                  n_classes=3)
        cells.append(R._build_gnn(arch, cfg, "small", sh, mesh, False))
    return cells


@pytest.mark.parametrize("cell", _one_rank_cells(), ids=lambda c: c.arch)
def test_meta_trace_counts_what_the_cpu_step_counts(cell):
    meta = dryrun.count_step(cell.fn, cell.local(), memory=False)
    cpu = dryrun.count_step(cell.fn, cell.materialize(0, "cpu"),
                            memory=False)
    assert meta["flops"] > 0
    assert meta["flops"] == cpu["flops"]
    assert meta["bytes"] == cpu["bytes"]
    assert meta["kernels"] == cpu["kernels"]


def _shapes(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(x.shape), x.dtype) for x in out]


def _kernel_calls():
    from repro_torch.kernels.pair_expand import ops as pe
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.kernels.spmm_join import ops as sj
    from repro_torch.kernels.bitonic_sort import ops as bs
    from repro_torch.core import segments

    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 50, (40,), generator=g, dtype=torch.int32)
    counts = torch.randint(0, 4, (12,), generator=g, dtype=torch.int32)
    prefix = torch.cumsum(counts, 0, dtype=torch.int32)
    data = torch.randn(40, 6, generator=g)
    ids = torch.sort(torch.randint(0, 9, (40,), generator=g)).values.to(
        torch.int32)
    return {
        "pair_expand": (pe.pair_expand, (prefix, counts, 30)),
        "match_layout": (sj.match_layout, (keys[:15], keys[15:])),
        "sort_ranks": (sj.sort_ranks, (keys,)),
        "cumsum_i32": (segments.cumsum_i32, (counts,)),
        "sorted_segment_sum": (sr.sorted_segment_sum, (data, ids, 9)),
        "sort_pairs": (bs.sort_pairs, (keys, keys.flip(0).contiguous())),
    }


def _meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_kernel_shape_rule_gives_the_plain_versions_shapes(name):
    fn, args = _kernel_calls()[name]
    assert _shapes(fn(*_meta(args))) == _shapes(fn(*args))


@pytest.mark.parametrize("name", ["pair_expand", "match_layout",
                                  "sort_ranks", "cumsum_i32"])
def test_kernel_shape_rule_under_vmap(name):
    fn, args = _kernel_calls()[name]
    lanes = tuple(torch.stack([a, a, a]) if isinstance(a, torch.Tensor)
                  else a for a in args)
    dims = tuple(0 if isinstance(a, torch.Tensor) else None for a in args)
    vm = torch.func.vmap(fn, in_dims=dims)
    assert _shapes(vm(*_meta(lanes))) == _shapes(vm(*lanes))


def test_meta_never_runs_the_plain_version():
    from repro_torch.kernels.bitonic_sort import ref as bs_ref
    from repro_torch.kernels.pair_expand import ref as pe_ref
    from repro_torch.kernels.segment_reduce import ref as sr_ref
    from repro_torch.kernels.spmm_join import ref as sj_ref

    calls = _kernel_calls()
    with mock.patch.object(pe_ref, "pair_expand") as a, \
            mock.patch.object(sj_ref, "match_layout") as b, \
            mock.patch.object(sj_ref, "sort_ranks") as c, \
            mock.patch.object(sr_ref, "sorted_segment_sum") as d, \
            mock.patch.object(bs_ref, "sort_pairs") as e:
        for name, (fn, args) in calls.items():
            if name != "cumsum_i32":
                fn(*_meta(args))
    for m in (a, b, c, d, e):
        m.assert_not_called()

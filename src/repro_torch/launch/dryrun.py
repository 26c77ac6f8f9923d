"""Dry-run: trace every (arch × input-shape × mesh) cell's step on a
production mesh of H100s, and extract the roofline inputs (per-device
FLOPs and bytes, per-device collective bytes, memory) with no card.

This process is rank 0 of a `fake` process group of 256 (16 x 16) or
512 (2 x 16 x 16) ranks (`launch/mesh.make_production_mesh`); the cell's
inputs are rank 0's blocks as meta tensors (`Cell.local`), which hold no
storage, so a 67B model's step traces on one host. The step runs eagerly
on them, every layer, under four counters:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` (matmuls,
    convolutions and attention; XLA's `cost_analysis`, which the
    reference reads, also counts elementwise work);
  * bytes: `obs.costs.OpBytes`, each dispatched op's inputs plus outputs
    (views excluded, each hand-written kernel one op): the same upper
    bound as XLA's "bytes accessed";
  * collectives: `obs.collectives.CollectiveBytes`, each call's operand
    bytes by kind, as the reference's `parse_collectives`;
  * memory: `torch.distributed._tools.mem_tracker.MemTracker`, the peak of
    the storage the step allocates (outputs included).

There is no lowering or compile: `t_trace_s` takes the place of
`t_lower_s` and `t_compile_s`, and `layer_probe` is null (an eager trace
counts every layer; the reference compiles L = 2 and L = 4 and
extrapolates, since XLA counts a scanned layer once).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh both --out results/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

# H100 SXM5 80 GB at its 700 W limit, from NVIDIA's H100 datasheet (dense
# rates, no sparsity). Derived constants, not measurements.
PEAK_FLOPS = 989.4e12  # bf16 tensor cores
HBM_BW = 3.35e12  # HBM3
HBM_BYTES = 80e9
NVLINK_BW = 450e9  # NVLink 4: 900 GB/s a card, both directions together
NET_BW = 50e9  # NDR InfiniBand, 400 Gb/s a card
NODE_CARDS = 8  # HGX H100: 8 cards a node on one NVLink switch
CONSTANTS = {
    "source": "NVIDIA H100 SXM5 80GB datasheet, 700 W (derived, not "
              "measured)",
    "peak_flops_bf16": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
    "hbm_bytes": HBM_BYTES, "nvlink_bytes_per_s": NVLINK_BW,
    "network_bytes_per_s": NET_BW, "cards_per_node": NODE_CARDS,
}
NO_COUNTERPART = {
    "t_lower_s": "no lowering: the step runs eagerly (t_trace_s)",
    "t_compile_s": "no compile: the step runs eagerly (t_trace_s)",
    "layer_probe": "an eager trace counts every layer",
    "flops_per_device": "FlopCounterMode: matmuls, convolutions and "
                        "attention; XLA also counts elementwise work",
}


def link_rate(ranks) -> float:
    """Bytes a second for a collective over these global ranks: NVLink
    when they all sit in one node (ranks n * 8 .. n * 8 + 7), the
    network when the group spans nodes (every axis of 16 does)."""
    nodes = {r // NODE_CARDS for r in ranks}
    return NVLINK_BW if len(nodes) == 1 else NET_BW


def count_step(fn, args, memory: bool = True) -> dict:
    """Run `fn(*args)` once under the counters: {"flops", "bytes", "coll"
    (a CollectiveBytes), "temp_bytes" (None without `memory`), "kernels"
    (calls of each hand-written kernel), "out", "seconds"}."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.obs.collectives import CollectiveBytes
    from repro_torch.obs.costs import OpBytes

    flops, ops, coll = FlopCounterMode(display=False), OpBytes(), \
        CollectiveBytes()
    mem = None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(coll)
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker

            mem = stack.enter_context(MemTracker())
        stack.enter_context(flops)
        stack.enter_context(ops)
        out = fn(*args)
    temp = None
    if mem is not None:
        peak = mem.get_tracker_snapshot("peak")
        temp = max((v["Total"] for v in peak.values()), default=0)
    return {"flops": float(flops.get_total_flops()), "bytes": float(ops.bytes),
            "coll": coll, "temp_bytes": temp, "kernels": dict(ops.kernels),
            "out": out, "seconds": time.perf_counter() - t0}


def run_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.configs.registry import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.obs.costs import nbytes

    ranks = make_production_mesh(multi_pod=multi_pod)
    n_chips = ranks.world_size
    cell = build_cell(arch, shape, ranks, multi_pod)
    args = cell.local()
    got = count_step(cell.fn, args)
    coll = got["coll"]
    flops_dev, bytes_dev = got["flops"], got["bytes"]
    arg_bytes = nbytes(args)
    out_bytes = nbytes(got["out"])
    alias = nbytes([args[i] for i in cell.donate])
    temp = got["temp_bytes"]
    rec = {
        "arch": arch,
        "shape": shape,
        "kind": cell.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n_chips,
        "device": "H100 SXM5 80GB (datasheet constants)",
        "t_trace_s": round(got["seconds"], 1),
        "t_lower_s": None,
        "t_compile_s": None,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll.record(),
        "memory": {
            "temp_bytes": temp,
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "alias_bytes": alias,
            "peak_bytes": temp + arg_bytes,
        },
        "fits_hbm": temp + arg_bytes <= HBM_BYTES,
        "model_flops_global": cell.model_flops,
        "layer_probe": None,
        "kernel_calls": got["kernels"],
        "host_sizes": cell.host_sizes,
        "note": cell.note,
        # roofline terms (seconds)
        "t_compute": flops_dev / PEAK_FLOPS,
        "t_memory": bytes_dev / HBM_BW,
        # the matching lower bound: only the per-device resident state
        # (arguments + outputs) crossing HBM once
        "t_memory_io": (arg_bytes + out_bytes - alias) / HBM_BW,
        "t_collective": coll.link_seconds(link_rate),
        "constants": CONSTANTS,
        "no_counterpart": NO_COUNTERPART,
    }
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    global_flops = flops_dev * n_chips
    rec["useful_flops_ratio"] = (
        cell.model_flops / global_flops if global_flops else 0.0)
    return rec


def main(argv: "list[str] | None" = None) -> int:
    from repro_torch.configs.registry import ARCHS, SHAPES_FOR

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES_FOR(a):
                cells.append((a, s))
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else list(SHAPES_FOR(args.arch))
        cells = [(args.arch, s) for s in shapes]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)", flush=True)
                continue
            print(f"[run ] {tag}", flush=True)
            try:
                rec = run_cell(arch, shape, mp)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(
                    f"[ ok ] {tag}: trace={rec['t_trace_s']}s "
                    f"flops/dev={rec['flops_per_device']:.3e} "
                    f"coll/dev={rec['collective_bytes_per_device']['total']:.3e}B "
                    f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB "
                    f"bottleneck={rec['bottleneck']}",
                    flush=True,
                )
            except Exception:
                failures += 1
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL] {tag}:\n{traceback.format_exc()}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

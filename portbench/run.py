"""The benchmark of the port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It exits non-zero and prints no result when there is no CUDA card, or
fewer than the cell needs, or when JAX or the JAX package was loaded.
Otherwise the last line of standard output is the result as one JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines on standard error and the result's last key. Every
build and kernel cache stays in the checkout's `build/` directory.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def _environment() -> None:
    """Fixed cache directories inside the checkout, and the port and the
    harness on the import path."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    # the harness imports as the package `portbench`, never by file name
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "portbench"]
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _finite(x):
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _card_line() -> None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not available"
    print(f"card: {out.strip()}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from portbench import harness
    from portbench.catalog import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    _card_line()
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    found = harness.forbidden_modules()  # the window has closed
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

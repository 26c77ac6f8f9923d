"""Hand-written CUDA kernels for the MapSQ hot spots, one package each.

Each kernel package has:
  csrc/*.cu — the CUDA C++ source for sm_90a, with a plain C launcher
  kernel.py — the ctypes binding: checks, output allocation, launch
  ref.py    — the plain PyTorch version of the same function
  ops.py    — the public op: the plain version for a CPU tensor, the kernel
              for a CUDA tensor (no fallback between the two)

Each source is compiled with nvcc into its own shared library under
`build/kernels/` at the repository root, on first use (`load`), or all at
once with one nvcc process per source, started together (`build_all`). Library names carry a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time: this module imports on
machines without nvcc or a card.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel, counted by each binding where it launches (and
# nowhere else): a run reads them to show which kernels it went through.
# One count is one call of the kernel's C launcher, which may issue more
# than one device launch (bitonic_sort issues one per global-memory pass).
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[tuple[str, str], ctypes.CDLL] = {}
_lock = threading.Lock()


def source(package: str, stem: str) -> pathlib.Path:
    return KERNELS_DIR / package / "csrc" / f"{stem}.cu"


def all_sources() -> list[tuple[str, str]]:
    """(package, stem) of every kernel source in the tree."""
    return [
        (p.parent.parent.name, p.stem)
        for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(package: str, stem: str) -> pathlib.Path:
    digest = hashlib.sha256(source(package, stem).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{package}_{stem}-{digest.hexdigest()[:16]}.so"


def _start_build(package: str, stem: str):
    """Start nvcc for one source unless its library is built. Writes to a
    temporary name first, so a concurrent reader never loads a
    half-written library."""
    out = library_path(package, stem)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source(package, stem))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, pathlib.Path(tmp), out


def _finish_build(started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Build every kernel source, one nvcc process per source, all started
    together."""
    started = [_start_build(*key) for key in all_sources()]
    errors = []
    for s in started:
        try:
            _finish_build(s)
        except RuntimeError as e:  # wait for every build before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(package: str, stem: str) -> ctypes.CDLL:
    """The shared library of one kernel source, built on first use."""
    with _lock:
        lib = _libs.get((package, stem))
        if lib is None:
            _finish_build(_start_build(package, stem))
            lib = ctypes.CDLL(str(library_path(package, stem)))
            _libs[(package, stem)] = lib
        return lib


def check_int32(x, what: str) -> None:
    """Refuse what the int32 kernels do not take: a CPU tensor, another
    type, a non-contiguous layout, or other than 1 or 2 dimensions (a 2-D
    tensor is a stack of lanes)."""
    if not x.is_cuda or x.dtype != torch.int32 or x.dim() not in (1, 2):
        raise ValueError(
            f"{what}: expected a 1-D or 2-D int32 CUDA tensor, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def lanes_of(x) -> tuple[int, int]:
    """(lanes, length) of a (length,) or stacked (lanes, length) input; the
    lane rides in the grid's y dimension, at most 65535."""
    lanes = x.shape[0] if x.dim() == 2 else 1
    if lanes > 65535:
        raise ValueError(f"{lanes} lanes exceed the grid's y dimension")
    return lanes, x.shape[-1]


def lanes_first(x, bdim, batch_size: int):
    """A vmapped op's input with its lane axis first: unbatched inputs
    (bdim None) are expanded to every lane."""
    if bdim is None:
        return x.unsqueeze(0).expand(batch_size, *x.shape)
    return x.movedim(bdim, 0)


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError() after
    the launch: a refused launch never runs and no later sync reports it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: error {err}")

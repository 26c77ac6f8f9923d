"""MapSQ in PyTorch for one NVIDIA H100: the SPARQL engine of `repro`, with
its Pallas kernels rewritten as hand-written CUDA kernels for Hopper.

The package mirrors `repro`'s layout and names and imports nothing from it
(nor from JAX): host layers are kept as copies, device code is plain
PyTorch around the kernels under `repro_torch.kernels`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and this
    machine has no card, so a run never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev

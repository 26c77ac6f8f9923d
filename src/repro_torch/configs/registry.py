"""Arch registry: arch id -> config module, for the archs this port runs
(the five LM archs). Each module holds `CONFIG` and `FAMILY`."""
from __future__ import annotations

import importlib

ARCHS: dict[str, str] = {
    # arch id -> config module
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
}


def family_of(arch: str) -> str:
    return importlib.import_module(ARCHS[arch]).FAMILY


def lm_layer_count(arch: str) -> int:
    return importlib.import_module(ARCHS[arch]).CONFIG.n_layers

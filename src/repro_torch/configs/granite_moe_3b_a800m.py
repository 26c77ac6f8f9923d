"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d_model=1536 24H (GQA kv=8)
d_ff(expert)=512 vocab=49155, MoE 40 experts top-8.

NOTE: the assignment lists both "MoE 40e top-8" and "32 experts top-8"; we
take the primary field (40 experts). 40 % 16 != 0, so experts are padded to
48 on a 16-way model axis (8 dead experts, -inf router logits; see
models/moe.py docstring).
"""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    d_expert_ff=512,
    rope_theta=1e4,
    dtype=torch.bfloat16,
    fsdp=False,
)
FAMILY = "lm"

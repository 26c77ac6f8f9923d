"""olmoe-1b-7b [arXiv:2409.02060; hf]: 16L d_model=2048 16H (GQA kv=16)
d_ff(expert)=1024 vocab=50304, MoE 64 experts top-8."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    d_expert_ff=1024,
    rope_theta=1e4,
    dtype=torch.bfloat16,
    fsdp=False,
)
FAMILY = "lm"

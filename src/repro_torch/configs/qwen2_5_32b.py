"""qwen2.5-32b [hf:Qwen]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA with QKV bias. FSDP posture (32B params)."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    dtype=torch.bfloat16,
    fsdp=True,
    # §Perf: fused chunked CE — logits (B,S,V) never materialize
    ce_chunk=1024,
)
FAMILY = "lm"

"""deepseek-67b [arXiv:2401.02954; hf]: 95L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=102400 — llama-arch dense. FSDP posture (67B params)."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab=102400,
    rope_theta=1e4,
    dtype=torch.bfloat16,
    fsdp=True,
    # §Perf: fused chunked CE — logits (B,S,V) never materialize
    ce_chunk=1024,
)
FAMILY = "lm"

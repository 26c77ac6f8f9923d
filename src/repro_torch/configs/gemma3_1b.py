"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144 — 5:1 local:global attention (window 512), 128k ctx,
QK-norm, tied embeddings, embed scaling."""
import torch

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab=262144,
    sliding_window=512,
    global_every=6,  # layers 6, 12, ... are global -> 5:1 local:global
    qk_norm=True,
    rope_theta=1e6,
    rope_theta_local=1e4,
    embed_scale=True,
    tied_embeddings=True,
    dtype=torch.bfloat16,
    fsdp=False,
)
FAMILY = "lm"

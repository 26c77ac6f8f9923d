"""graphcast [arXiv:2212.12794]: 16 processor layers, d_hidden=512,
mesh_refinement=6, sum aggregator, n_vars=227 (encoder-processor-decoder)."""
from repro_torch.models.gnn.graphcast import GraphCastConfig

CONFIG = GraphCastConfig(n_layers=16, d_hidden=512, n_vars=227,
                         mesh_refinement=6)
FAMILY = "gnn"

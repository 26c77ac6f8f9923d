"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden=8, 8 heads, attn aggregator."""
from repro_torch.models.gnn.gat import GATConfig

CONFIG = GATConfig(n_layers=2, d_hidden=8, n_heads=8, n_classes=7, d_in=1433)
FAMILY = "gnn"

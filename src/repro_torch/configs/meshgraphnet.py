"""meshgraphnet [arXiv:2010.03409]: 15 layers, d_hidden=128, sum aggregator,
2-layer MLPs."""
from repro_torch.models.gnn.meshgraphnet import MGNConfig

CONFIG = MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2, d_node_in=8,
                   d_edge_in=4, d_out=3)
FAMILY = "gnn"

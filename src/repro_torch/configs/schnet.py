"""schnet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10."""
from repro_torch.models.gnn.schnet import SchNetConfig

CONFIG = SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)
FAMILY = "gnn"

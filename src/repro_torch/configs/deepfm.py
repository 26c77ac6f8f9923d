"""deepfm [arXiv:1703.04247]: n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm. ~33.5M embedding rows (Criteo-scale; 1.34 GB in float32),
on one device in this port."""
from repro_torch.models.recsys.deepfm import DeepFMConfig

CONFIG = DeepFMConfig(n_sparse=39, embed_dim=10, mlp_dims=(400, 400, 400),
                      rows_per_field=860_000)
FAMILY = "recsys"

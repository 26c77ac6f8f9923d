"""Synthetic data pipelines of the GNN and recsys families (host numpy)."""

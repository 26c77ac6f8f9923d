"""Model code: the LM transformer family (dense and MoE blocks), the GNN
family (`gnn/`) and DeepFM (`recsys/`)."""

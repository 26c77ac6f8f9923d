"""Model code: the LM transformer family (dense and MoE blocks)."""

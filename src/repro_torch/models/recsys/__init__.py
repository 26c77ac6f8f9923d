"""Recommendation family: DeepFM over sparse embedding tables."""

"""Sorted segment sum: the shared Reduce phase over sorted ids."""

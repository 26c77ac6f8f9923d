"""Pair expansion: the inverse-prefix-sum gather of the MR join."""

"""GNN family. Message passing = the paper's pipeline: edges are sorted by
destination once at load time (the Sort phase), and aggregation is a
sorted segment reduce (the ReduceDuplicate phase; `kernels.segment_reduce`
on the card) — the same machinery as the SPARQL join, with node ids as
keys.
"""

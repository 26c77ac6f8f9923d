"""The SPARQL serving tier: micro-batcher, decode pool and server."""

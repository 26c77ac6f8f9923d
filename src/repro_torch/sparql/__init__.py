"""RDF/SPARQL substrate: dictionary encoding, indexed triple store, a SPARQL
parser, LUBM-style data generation, and the query engine."""

"""The paper's own workload: distributed MapReduce join over LUBM-style
dictionary-encoded relations (the 11th 'architecture')."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MapSQConfig:
    left_schema: tuple[str, ...] = ("?x", "?y")
    right_schema: tuple[str, ...] = ("?y", "?z")
    bucket_capacity: int = 4096
    join_capacity: int = 65536


CONFIG = MapSQConfig()
FAMILY = "sparql"

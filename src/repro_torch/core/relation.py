"""Dictionary-encoded relations: the tables MapSQ's Algorithm 1 joins.

A Relation is a fixed-capacity buffer of int32 rows, one column per SPARQL
variable, plus a bool validity mask (the paper's partial-match tables,
Table 1a/1b). Capacities are static so a plan program never needs a
data-dependent shape; the mask is the Mars-style answer to dynamic result
sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

# Sentinel keys: invalid rows are sent to distinct, never-equal key values so
# they sort to the end and can never pair up across sides.
INVALID_LEFT = np.int32(2**31 - 1)
INVALID_RIGHT = np.int32(2**31 - 2)

# Term-id sentinel for variables an OPTIONAL group left unbound. Real term
# ids are dense non-negative ints, so -1 can never collide; FILTER masks and
# the result decoder treat it as "no binding".
UNBOUND = np.int32(-1)


@dataclasses.dataclass
class Relation:
    """A dictionary-encoded relation with static capacity.

    Attributes:
      schema: variable name per column (the pytree's static context).
      cols:   (capacity, n_cols) int32 term ids. A leading lane axis —
              (width, capacity, n_cols) — is allowed so stacked same-shape
              queries travel as one pytree through the vmapped executor.
      valid:  (capacity,) bool — rows beyond the real result are padding.
    """

    schema: tuple[str, ...]
    cols: torch.Tensor
    valid: torch.Tensor

    def __post_init__(self):
        # torch.func.vmap also rebuilds Relations whose leaves are its
        # integer in/out dims, so only tensors are checked
        if isinstance(self.cols, torch.Tensor) and (
            self.cols.dim() < 2 or len(self.schema) != self.cols.shape[-1]
        ):
            raise ValueError(
                f"schema {self.schema} does not fit cols {tuple(self.cols.shape)}"
            )

    @property
    def capacity(self) -> int:
        return self.cols.shape[-2]

    @property
    def n_cols(self) -> int:
        return self.cols.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def column(self, var: str) -> torch.Tensor:
        return self.cols[:, self.schema.index(var)]

    def project(self, vars: Sequence[str]) -> "Relation":
        # columns gathered one by one: an index list would be copied to the
        # device, a host sync inside the plan program
        idx = [self.schema.index(v) for v in vars]
        if idx == list(range(self.n_cols)):
            cols = self.cols
        elif idx:
            cols = torch.stack([self.cols[:, i] for i in idx], dim=1)
        else:
            cols = self.cols[:, :0]
        return Relation(tuple(vars), cols, self.valid)

    def to_numpy(self) -> np.ndarray:
        """Compact valid rows to host (syncs with the device)."""
        cols = self.cols.cpu().numpy()
        valid = self.valid.cpu().numpy()
        return cols[valid]

    def to_set(self) -> set[tuple[int, ...]]:
        return {tuple(int(x) for x in row) for row in self.to_numpy()}

    @classmethod
    def from_numpy(
        cls,
        schema: Sequence[str],
        rows: np.ndarray,
        capacity: int | None = None,
        device="cpu",
    ) -> "Relation":
        rows = np.asarray(rows, dtype=np.int32).reshape(len(rows), len(schema))
        capacity = capacity or max(1, len(rows))
        if capacity < len(rows):
            raise ValueError(f"{len(rows)} rows exceed capacity {capacity}")
        cols = np.zeros((capacity, len(schema)), dtype=np.int32)
        cols[: len(rows)] = rows
        valid = np.zeros((capacity,), dtype=bool)
        valid[: len(rows)] = True
        return cls(
            tuple(schema),
            torch.from_numpy(cols).to(device),
            torch.from_numpy(valid).to(device),
        )


# A pytree for torch.func: cols and valid are the leaves, the schema is the
# static context, so vmap takes a stacked scan at in_dims 0 and a scan every
# lane shares (one buffer) at in_dims None.
pytree.register_pytree_node(
    Relation,
    lambda r: ((r.cols, r.valid), r.schema),
    lambda leaves, schema: Relation(schema, *leaves),
    serialized_type_name="repro_torch.core.relation.Relation",
)


def pad_to(rel: Relation, capacity: int) -> Relation:
    """The same relation at a larger static capacity: appended rows are
    zero ids with valid=False, so every masked operator treats them as
    absent. A no-op at equal capacity."""
    cur = rel.capacity
    if capacity == cur:
        return rel
    if capacity < cur:
        raise ValueError(f"cannot pad capacity {cur} down to {capacity}")
    extra = capacity - cur
    return Relation(
        rel.schema,
        torch.cat([rel.cols, rel.cols.new_zeros((extra, rel.n_cols))]),
        torch.cat([rel.valid, rel.valid.new_zeros((extra,))]),
    )


def shared_vars(a: Relation | Sequence[str], b: Relation | Sequence[str]) -> list[str]:
    sa = a.schema if isinstance(a, Relation) else tuple(a)
    sb = b.schema if isinstance(b, Relation) else tuple(b)
    return [v for v in sa if v in sb]

"""What a rank hands `torch.distributed`'s collectives, counted at each
call: the port's counterpart of the reference's `parse_collectives`
(`launch/dryrun.py`), which sums the operands of every collective in the
partitioned HLO.

    with CollectiveBytes() as counted:
        step(...)
    counted.record()  # {"all-to-all": ..., "total", "link_bytes", "counts"}

The port calls three collectives on its data path: `all_to_all_single`
(every exchange, and the reduce-scatter, which the port writes as an
exchange and a sum), `all_gather_into_tensor` and `all_reduce`. Each is
counted under the reference's name for its kind, by the bytes of its
input on this rank (the operand size, as the reference counts it).
"""
from __future__ import annotations

import time

import torch

# torch.distributed's name -> the reference's (HLO) name for the kind
KINDS = {
    "all_to_all_single": "all-to-all",
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
}


class CollectiveBytes:
    """While entered: the bytes this rank hands torch.distributed's
    collectives (each call's input, in all and by kind), the part of them
    that must reach another rank (`remote`: an exchange's rows for the
    others, an all-gather's input once for each other rank, an
    all-reduce's 2 (n - 1) / n of its input as a ring moves it), the
    calls and, with `timed`, the seconds spent in them between a
    synchronize of the card before and after each (every wait on the
    peers and on the card counted; a run of its own, as the syncs stop
    the host running ahead); the counts add up over every entry. Patches
    the three collectives the port calls."""

    NAMES = tuple(KINDS)

    def __init__(self, timed: bool = False):
        self.bytes = 0
        self.remote = 0
        self.calls = 0
        self.seconds = 0.0
        self.timed = timed
        self.by_kind: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        # (kind, the group's global ranks) -> bytes, for link rates by group
        self.by_group: dict[tuple, int] = {}
        self._members: dict[int, tuple] = {}

    def __enter__(self):
        import torch.distributed as dist

        self._dist = dist
        self._orig = {n: getattr(dist, n) for n in self.NAMES}
        for n, f in self._orig.items():
            setattr(dist, n, self._counted(f, n))
        return self

    def _remote(self, name: str, args, kw) -> int:
        dist = self._dist
        group = kw.get("group")
        size = dist.get_world_size(group)
        src = args[0] if name == "all_reduce" else args[1]
        n = src.numel() * src.element_size()
        if name == "all_reduce":
            return 2 * n * (size - 1) // size
        if name == "all_gather_into_tensor":
            return n * (size - 1)
        splits = args[3] if len(args) > 3 else kw.get("input_split_sizes")
        me = dist.get_rank(group)
        row = n // max(1, src.shape[0])
        return n - (splits[me] * row if splits else n // size)

    def _ranks_of(self, group) -> tuple:
        """The global ranks of `group` (None: the world)."""
        if id(group) not in self._members:
            dist = self._dist
            g = group if group is not None else dist.group.WORLD
            self._members[id(group)] = tuple(dist.get_process_group_ranks(g))
        return self._members[id(group)]

    def _counted(self, f, name: str):
        kind = KINDS[name]

        def call(*args, **kw):
            src = args[0] if name == "all_reduce" else args[1]
            n = src.numel() * src.element_size()
            self.bytes += n
            self.by_kind[kind] = self.by_kind.get(kind, 0) + n
            self.counts[kind] = self.counts.get(kind, 0) + 1
            key = (kind, self._ranks_of(kw.get("group")))
            self.by_group[key] = self.by_group.get(key, 0) + n
            self.remote += self._remote(name, args, kw)
            self.calls += 1
            if not self.timed:
                return f(*args, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t

        return call

    def __exit__(self, *exc):
        for n, f in self._orig.items():
            setattr(self._dist, n, f)

    def link_seconds(self, rate) -> float:
        """The seconds the counted collectives take on their links at
        `rate(ranks)` bytes a second for a group of those global ranks, an
        all-reduce moving twice its operand."""
        return sum(n * (2.0 if kind == "all-reduce" else 1.0) / rate(ranks)
                   for (kind, ranks), n in self.by_group.items())

    def record(self) -> dict:
        """The bytes by kind, "total", "link_bytes" (an all-reduce moves
        about twice its operand) and "counts": the keys of the
        reference's `parse_collectives`."""
        out: dict = dict(self.by_kind)
        out["total"] = sum(self.by_kind.values())
        out["link_bytes"] = float(sum(
            n * (2.0 if k == "all-reduce" else 1.0)
            for k, n in self.by_kind.items()))
        out["counts"] = dict(self.counts)
        return out

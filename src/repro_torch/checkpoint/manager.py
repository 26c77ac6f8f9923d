"""Fault-tolerant checkpointing: step-addressed, atomic, keep-k, async.

Layout, the reference's (`repro.checkpoint.manager`) byte for byte:
<dir>/step_{N:08d}/arrays.npz + meta.json, written to a tmp dir and
atomically renamed (a crashed writer never corrupts the latest good
step). The npz holds the leaves as a0, a1, ... in `jax.tree.flatten`
order (dict keys sorted at every level: `repro_torch.tree`), bfloat16 as
its uint16 bits, so a checkpoint either package writes restores in the
other bit for bit. meta.json holds the step, a description of the tree,
the time and the caller's extra fields (the trainer's pipeline state).

`save` copies every leaf to host memory before it returns (the caller may
free or replace the device tensors at once); with `async_write` a thread
then writes the files, one writer in flight at a time.
`restore(step, like_tree, device=...)` loads into `like_tree`'s structure
and dtypes.

Across ranks (`ranks` and a spec tree `specs`, each leaf this rank's
block; `core/specs.py`) every rank calls `save` together: each leaf is
all-gathered whole, one leaf at a time, and rank 0 writes the same files
as one process; every rank waits for the write (`wait`, which ends in a
barrier). `restore(..., ranks=, specs=)` reads the whole leaves on every
rank and keeps its blocks: the reference's elastic `shardings=`, so a
checkpoint written on one mesh, or by one process, restores on another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as TT
from repro_torch.core import specs as S


def _to_host(t) -> np.ndarray:
    """A host copy of one leaf (a tensor, or anything numpy takes); bf16
    as its uint16 bits (npz cannot hold bfloat16)."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    bf16 = t.dtype == torch.bfloat16
    t = t.detach().view(torch.int16) if bf16 else t.detach()
    a = t.to("cpu", copy=True).numpy()  # a copy, on the CPU too
    return a.view(np.uint16) if bf16 else a


def _from_host(a: np.ndarray, like, device) -> torch.Tensor:
    """A stored array as a tensor of `like`'s dtype on `device`."""
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.asarray(a, order="C").view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(a, order="C"))
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep_k = keep_k
        self.async_write = async_write
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._ranks = None  # the rank context of the last save across ranks
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree, extra_meta: dict | None = None, *,
             ranks=None, specs=None) -> None:
        """Blocking or async depending on construction. The tree is
        snapshotted to host BEFORE returning, so the caller may free or
        replace device tensors immediately. With `ranks` and `specs`
        (every rank calls it) the leaves are this rank's blocks, gathered
        whole one at a time; rank 0 writes."""
        self.wait()  # one writer in flight at a time
        lead = ranks is None or ranks.rank == 0
        if ranks is None:
            host = [_to_host(x) for x in TT.leaves(tree)]
        else:
            self._ranks = ranks
            host = []
            for x, spec in zip(TT.leaves(tree), S.spec_leaves(specs, tree)):
                whole = (S.gather(x, spec, ranks)
                         if isinstance(x, torch.Tensor) else x)
                if lead:
                    host.append(_to_host(whole))
                del whole
        if not lead:
            return
        meta = {
            "step": step,
            "treedef": " ".join(TT.paths(tree)),
            "time": time.time(),
            **(extra_meta or {}),
        }
        if self.async_write:
            t = threading.Thread(target=self._write_logged,
                                 args=(step, host, meta), daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, host, meta)

    def _write_logged(self, step, host, meta):
        try:
            self._write(step, host, meta)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def _write(self, step: int, host_leaves: list[np.ndarray], meta: dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host_leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._prune()

    def wait(self) -> None:
        """Wait for the writer in flight; a failed write raises here.
        After a save across ranks every rank waits for rank 0's write."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._ranks is not None:
            dist.barrier(group=self._ranks.control)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_k]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, step: int, like_tree, device=None, *, ranks=None,
                specs=None):
        """Restore into the structure and dtypes of `like_tree`, on
        `device` (default: each leaf's own device in `like_tree`). With
        `ranks` and `specs` each leaf of `like_tree` is this rank's block
        and gets its block of the whole stored leaf, whatever mesh (or one
        process) wrote it."""
        d = self._step_dir(step)
        leaves = TT.leaves(like_tree)
        cut = (S.spec_leaves(specs, like_tree) if ranks is not None
               else [None] * len(leaves))
        new = []
        with np.load(os.path.join(d, "arrays.npz")) as z:
            assert len(leaves) == len(z.files), (
                f"checkpoint has {len(z.files)} leaves, model wants "
                f"{len(leaves)}"
            )
            for i, (leaf, spec) in enumerate(zip(leaves, cut)):
                dev = (device if device is not None
                       else getattr(leaf, "device", "cpu"))
                if spec is None:
                    new.append(_from_host(z[f"a{i}"], leaf, dev))
                    continue
                block = S.shard(_from_host(z[f"a{i}"], leaf, "cpu"), spec,
                                ranks)
                if isinstance(leaf, torch.Tensor) and \
                        tuple(block.shape) != tuple(leaf.shape):
                    raise ValueError(f"leaf {i}: block {tuple(block.shape)}"
                                     f", the model's {tuple(leaf.shape)}")
                new.append(block.to(dev))
        return TT.unflatten(like_tree, new)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

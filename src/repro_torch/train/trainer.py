"""Training loop (the port of `repro.train.trainer`) with the
fault-tolerance contract a 1000-node job needs:

  * step-addressed checkpoints of (params, opt_state, data-pipeline state),
    async writer, keep-k, atomic commit (checkpoint/manager.py);
  * crash-and-restart: `run()` resumes from the latest checkpoint — the
    deterministic pipelines regenerate the exact remaining stream;
  * failure injection for tests (`fail_at_step` raises mid-run after the
    optimizer update, before the checkpoint, like a real preemption);
  * straggler posture: grad-accum microbatching bounds the per-step work
    unit; NaN-step skipping (metric-gated) bounds bad-host blast radius.

A step's metrics (0-d tensors on the device) come to the host in one
copy: one sync per step, not one per metric.

Across ranks (`ranks`, and `specs` for this rank's param blocks) every
rank steps, on its data coordinate's rows of each global batch
(`data.tokens.data_rows`); the checkpoints are gathered whole and rank 0
writes them, every rank waiting for the write; a resume restores the
step rank 0 finds, params, opt state and the pipeline's cursor, on every
rank; only rank 0 prints.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import data_rows
from repro_torch.optim.adamw import adamw_init, state_specs


class SimulatedFailure(RuntimeError):
    pass


def host_metrics(metrics: dict) -> dict[str, float]:
    """A step's metrics as Python floats, the tensors read in one host
    copy (the same numbers as `float()` of each)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


@dataclasses.dataclass
class TrainSettings:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    keep_k: int = 3
    async_ckpt: bool = True
    fail_at_step: int = -1  # test hook: raise after this step once
    skip_nonfinite_steps: bool = True


class Trainer:
    """Drives (train_step, pipeline, checkpoint) to a step budget."""

    def __init__(
        self,
        train_step: Callable,  # (params, opt_state, batch) -> (p, s, metrics)
        params: Any,
        pipeline: Any,  # __next__ + state_dict/load_state_dict
        ckpt_dir: str,
        settings: TrainSettings = TrainSettings(),
        opt_state: Any = None,
        to_device: Callable | None = None,
        ranks: Any = None,
        specs: Any = None,
    ):
        self.train_step = train_step
        self.params = params
        self.ranks = ranks
        self.opt_state = opt_state if opt_state is not None else adamw_init(
            params, specs, ranks)
        # the spec tree of a checkpoint's {"params", "opt"} across ranks
        self.ckpt_specs = None if ranks is None else {
            "params": specs, "opt": state_specs(params, specs, ranks)}
        self.pipeline = pipeline
        self.s = settings
        self.mgr = CheckpointManager(ckpt_dir, keep_k=settings.keep_k,
                                     async_write=settings.async_ckpt)
        self.to_device = to_device or (lambda b: b)
        self.step = 0
        self.history: list[dict] = []
        self._failed_once = False

    # -- checkpoint glue ---------------------------------------------------
    def _save(self) -> None:
        tree = {"params": self.params, "opt": self.opt_state}
        self.mgr.save(self.step, tree,
                      extra_meta={"pipeline": self.pipeline.state_dict()},
                      ranks=self.ranks, specs=self.ckpt_specs)

    def _restore(self, step: int) -> None:
        like = {"params": self.params, "opt": self.opt_state}
        tree = self.mgr.restore(step, like, ranks=self.ranks,
                                specs=self.ckpt_specs)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.pipeline.load_state_dict(self.mgr.meta(step)["pipeline"])
        self.step = step

    @property
    def lead(self) -> bool:
        return self.ranks is None or self.ranks.rank == 0

    def _rows(self, batch):
        """This rank's rows of a global batch (all of it in one process)."""
        if self.ranks is None or "data" not in self.ranks.mesh.axis_names:
            return batch
        return data_rows(batch, self.ranks.axis_index("data"),
                         self.ranks.axis_size("data"))

    def resume_if_possible(self) -> bool:
        latest = self.mgr.latest_step()
        if self.ranks is not None:  # rank 0's view, on every rank
            latest = self.ranks.broadcast(latest)
        if latest is None:
            return False
        self._restore(latest)
        return True

    # -- main loop -----------------------------------------------------------
    def run(self) -> list[dict]:
        while self.step < self.s.total_steps:
            batch = self.to_device(self._rows(next(self.pipeline)))
            t0 = time.time()
            new_p, new_s, metrics = self.train_step(
                self.params, self.opt_state, batch
            )
            metrics = host_metrics(metrics)
            if self.s.skip_nonfinite_steps and not all(
                math.isfinite(v) for v in metrics.values()
            ):
                # bad step (bad host / overflow): drop the update, keep going
                metrics["skipped"] = 1.0
            else:
                self.params, self.opt_state = new_p, new_s
            self.step += 1
            metrics["step"] = self.step
            metrics["dt"] = time.time() - t0
            self.history.append(metrics)
            if (self.lead and self.s.log_every
                    and self.step % self.s.log_every == 0):
                print(
                    f"step {self.step}: "
                    + " ".join(f"{k}={v:.4g}" for k, v in metrics.items()
                               if k not in ("step",)),
                    flush=True,
                )
            if (
                self.s.fail_at_step == self.step and not self._failed_once
            ):
                self._failed_once = True
                raise SimulatedFailure(f"injected failure at {self.step}")
            if self.s.ckpt_every and self.step % self.s.ckpt_every == 0:
                self._save()
        self.mgr.wait()
        return self.history


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 3) -> Trainer:
    """Supervisor loop: restart-from-checkpoint on failure (the single-
    process analogue of a cluster controller rescheduling a died job).
    Across ranks every rank runs it: the injected failure strikes every
    rank at the same step, each waits for the write in flight, and all
    restart together from the checkpoint rank 0 finds."""
    restarts = 0
    while True:
        tr = make_trainer()
        tr.resume_if_possible()
        try:
            tr.run()
            return tr
        except SimulatedFailure:
            tr.mgr.wait()
            restarts += 1
            if restarts > max_restarts:
                raise


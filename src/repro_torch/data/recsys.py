"""Synthetic CTR stream for deepfm: zipf-distributed sparse ids (hot-key
skew like real logs), deterministic per (seed, step)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CTRPipeline:
    n_sparse: int
    rows_per_field: int
    batch: int
    seed: int = 0
    step: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        ids = (rng.zipf(1.2, size=(self.batch, self.n_sparse))
               % self.rows_per_field).astype(np.int32)
        # a planted linear signal so training has something to learn
        logit = (ids[:, 0] % 7 - 3) * 0.7 + rng.normal(size=self.batch) * 0.3
        labels = (logit > 0).astype(np.float32)
        return {"ids": ids, "labels": labels}

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st):
        self.seed, self.step = int(st["seed"]), int(st["step"])

"""Synthetic, seeded recsys batches: copies of the JAX package's
``data/pipeline.py`` ``DataCursor``, ``_seed_for`` and ``RecsysPipeline``.

They are numpy only, and for the same seed and cursor give the same arrays
as the reference: deterministic per-(shard, step) seeding, so a restored
job replays the exact stream from its data cursor, and Zipf-ish ids (80% of
lookups in the first 1% of each field's rows) that exercise the
embedding-bag gather as real traffic does. ``LMTokenPipeline`` and the GNN
batches wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.config.base import RecsysConfig, ShapeSpec


@dataclass
class DataCursor:
    """Pipeline position."""
    step: int = 0
    shard: int = 0


def _seed_for(base: int, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([base, shard, step]).generate_state(4)
    )


class RecsysPipeline:
    def __init__(self, cfg: RecsysConfig, shape: ShapeSpec, seed: int = 0):
        self.cfg, self.shape = cfg, shape
        self.seed = seed

    def batch(self, cursor: DataCursor) -> Dict[str, np.ndarray]:
        r = _seed_for(self.seed, cursor.shard, cursor.step)
        B = self.shape.batch
        F, bag, V = self.cfg.n_sparse, max(self.cfg.multi_hot, 1), self.cfg.vocab_per_field
        # Zipf head: 80% of lookups hit the first 1% of rows
        hot = max(V // 100, 1)
        coin = r.random((B, F, bag)) < 0.8
        ids = np.where(
            coin,
            r.integers(0, hot, (B, F, bag)),
            r.integers(0, V, (B, F, bag)),
        ).astype(np.int32)
        mask = np.ones((B, F, bag), np.float32)
        dense = r.standard_normal((B, self.cfg.n_dense)).astype(np.float32)
        labels = r.integers(0, 2, B).astype(np.int32)
        return {"ids": ids, "id_mask": mask, "dense": dense, "labels": labels}

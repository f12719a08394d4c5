"""Synthetic, seeded recsys and GNN batches: copies of the JAX package's
``data/pipeline.py`` ``DataCursor``, ``_seed_for``, ``RecsysPipeline``,
``gnn_full_graph_batch`` and ``gnn_molecule_batch``.

They are numpy only, and for the same seed and cursor give the same arrays
as the reference: deterministic per-(shard, step) seeding, so a restored
job replays the exact stream from its data cursor, and Zipf-ish ids (80% of
lookups in the first 1% of each field's rows) that exercise the
embedding-bag gather as real traffic does. The GNN batches give the same
arrays as the reference's for the same seed. ``LMTokenPipeline`` waits for
its slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.config.base import GNNConfig, RecsysConfig, ShapeSpec


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


def gnn_full_graph_batch(cfg: GNNConfig, shape: ShapeSpec, seed: int = 0,
                         n_classes: int = 7) -> Dict[str, np.ndarray]:
    """Synthetic full-graph batch at the shape's (n_nodes, n_edges) scale.
    RMAT-ish degree skew, features/labels/positions as the arch needs."""
    r = np.random.default_rng(seed)
    n, e = shape.n_nodes, shape.n_edges
    # power-ish degree: endpoints = floor(n * u^2)
    src = (n * r.random(e) ** 2).astype(np.int32) % n
    dst = (n * r.random(e) ** 2).astype(np.int32) % n
    x = r.standard_normal((n, shape.d_feat)).astype(np.float32)
    return {
        "x": x,
        "src": src,
        "dst": dst,
        "labels": r.integers(0, n_classes, n).astype(np.int32),
        "pos": r.standard_normal((n, 3)).astype(np.float32),
    }


def gnn_molecule_batch(cfg: GNNConfig, shape: ShapeSpec, seed: int = 0,
                       d_feat: int = 32) -> Dict[str, np.ndarray]:
    """`n_graphs` disjoint molecules flattened into one padded graph."""
    r = np.random.default_rng(seed)
    g, n, e = shape.n_graphs, shape.n_nodes, shape.n_edges
    N, E = g * n, g * e
    offs = np.repeat(np.arange(g, dtype=np.int32) * n, e)
    src = (r.integers(0, n, E).astype(np.int32) + offs)
    dst = (r.integers(0, n, E).astype(np.int32) + offs)
    return {
        "x": r.standard_normal((N, d_feat)).astype(np.float32),
        "src": src,
        "dst": dst,
        "pos": r.standard_normal((N, 3)).astype(np.float32),
        "graph_id": np.repeat(np.arange(g, dtype=np.int32), n),
        "targets": r.standard_normal((g, 1)).astype(np.float32),
        "labels": np.zeros(N, np.int32),
    }

"""Synthetic, seeded LM, recsys and GNN batches: copies of the JAX
package's ``data/pipeline.py`` ``DataCursor``, ``_seed_for``,
``LMTokenPipeline``, ``RecsysPipeline``, ``gnn_full_graph_batch`` and
``gnn_molecule_batch``, and ``gnn_minibatch_batch``, which fills the
reference's ``minibatch`` cell from the neighbor sampler (the reference
declares that cell's inputs but has no batch function for it).

They are numpy only, and for the same seed and cursor give the same arrays
as the reference: deterministic per-(shard, step) seeding, so a restored
job replays the exact stream from its data cursor; uniform random tokens
with shifted labels (-1 masks the last position); and Zipf-ish ids (80% of
lookups in the first 1% of each field's rows) that exercise the
embedding-bag gather as real traffic does. The GNN batches give the same
arrays as the reference's for the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.config.base import (GNNConfig, RecsysConfig, ShapeSpec,
                                     TransformerConfig)
from repro_torch.models.gnn import GNN_EDGE_DIM

OVERDECOMPOSE = 4   # logical data shards per host


@dataclass
class DataCursor:
    """Checkpointable pipeline position."""
    step: int = 0
    shard: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"step": self.step, "shard": self.shard}

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "DataCursor":
        return DataCursor(step=int(d.get("step", 0)),
                          shard=int(d.get("shard", 0)))


def _seed_for(base: int, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([base, shard, step]).generate_state(4)
    )


class LMTokenPipeline:
    def __init__(self, cfg: TransformerConfig, shape: ShapeSpec,
                 n_hosts: int = 1, seed: int = 0):
        self.cfg, self.shape = cfg, shape
        self.n_shards = n_hosts * OVERDECOMPOSE
        self.seed = seed

    def batch(self, cursor: DataCursor) -> Dict[str, np.ndarray]:
        r = _seed_for(self.seed, cursor.shard, cursor.step)
        B, S = self.shape.global_batch, self.shape.seq_len
        toks = r.integers(0, self.cfg.vocab_size, (B, S), dtype=np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cur = DataCursor()
        while True:
            yield self.batch(cur)
            cur.step += 1


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


def minibatch_padding(shape: ShapeSpec) -> Tuple[int, int]:
    """The reference cell's padded sizes of a ``minibatch`` shape on one
    device, from ``(batch_nodes, fanout)``: ``pad_n = b (f1 + 1) (f0 + 1)``
    nodes and ``pad_e = n1 f0 + b f1`` edges, ``n1 = b (f1 + 1)``."""
    b = shape.batch_nodes
    f1, f0 = shape.fanout
    n1 = b * (f1 + 1)
    return n1 * (f0 + 1), n1 * f0 + b * f1


def _gather_rows(table: Any, ids: np.ndarray, n_real: int, fill) -> Any:
    """``table[ids]`` with the rows from ``n_real`` on set to ``fill``: on
    the host for a numpy table, on the table's device for a tensor (only
    the ids are uploaded)."""
    if isinstance(table, torch.Tensor):
        out = table[torch.from_numpy(ids).to(table.device)]
    else:
        out = table[ids]
    out[n_real:] = fill
    return out


def gnn_minibatch_batch(cfg: GNNConfig, shape: ShapeSpec, sampler,
                        table: Mapping[str, Any], cursor: DataCursor,
                        seed: int = 0, pad: Tuple[int, int] = None
                        ) -> Dict[str, Any]:
    """The ``minibatch`` cell's inputs for step ``cursor`` from one
    ``sampler.sample`` call (``graph/sampler.py``, over the full graph
    whose node ``table`` holds ``x`` [n, F], ``labels`` [n] and, for
    equiformer-v2, ``pos`` [n, 3]: numpy arrays, or tensors on a device,
    where the rows are then gathered). The mapping:
      * seeds: ``_seed_for(seed, shard, step).choice(n, batch_nodes,
        replace=False)``, ``n`` the table's rows;
      * node table: the sampled nodes first, in ``node_ids`` order, cut to
        ``pad_n`` rows; padding slots have ``x = 0``, ``labels = -1`` and
        ``pos = 0``;
      * edges: both blocks' masked edges, deepest block first as the
        sampler lists them, then inert self-loops on the last padding node
        up to ``pad_e``;
      * ``seed_slots``: the sampler's;
      * ``e`` (gatedgcn, meshgraphnet): ``[pad_e, GNN_EDGE_DIM]`` standard
        normal, float32, drawn from the step's generator after the seeds.
    ``pad`` is ``(pad_n, pad_e)``, ``minibatch_padding(shape)`` by default.
    Raises when the sample leaves no padding node or passes ``pad_e``."""
    pad_n, pad_e = pad if pad is not None else minibatch_padding(shape)
    r = _seed_for(seed, cursor.shard, cursor.step)
    n = int(table["x"].shape[0])
    seeds = r.choice(n, shape.batch_nodes, replace=False)
    sb = sampler.sample(seeds)
    n_real = int(sb.node_mask.sum())
    src = np.concatenate([b.src_index[b.edge_mask] for b in sb.blocks])
    dst = np.concatenate([b.dst_index[b.edge_mask] for b in sb.blocks])
    if n_real >= pad_n or len(src) > pad_e:
        raise ValueError(f"gnn_minibatch_batch: {n_real} sampled nodes and "
                         f"{len(src)} edges do not fit {pad_n} slots (one "
                         f"kept for padding) and {pad_e} edges")
    loops = np.full(pad_e - len(src), pad_n - 1, dtype=np.int32)
    ids = np.zeros(pad_n, dtype=np.int32)
    ids[:n_real] = sb.node_ids[:n_real]
    out = {"x": _gather_rows(table["x"], ids, n_real, 0),
           "src": np.concatenate([src, loops]),
           "dst": np.concatenate([dst, loops]),
           "labels": _gather_rows(table["labels"], ids, n_real, -1),
           "seed_slots": sb.seed_slots}
    if cfg.kind == "equiformer_v2":
        out["pos"] = _gather_rows(table["pos"], ids, n_real, 0)
    if cfg.kind in GNN_EDGE_DIM:
        out["e"] = r.standard_normal(
            (pad_e, GNN_EDGE_DIM[cfg.kind])).astype(np.float32)
    return out

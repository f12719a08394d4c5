"""Neighbor sampler for minibatch GNN training (the ``minibatch_lg``
regime): the port of the JAX package's ``graph/sampler.py``.

Layer-wise fanout sampling (GraphSAGE style): given seed nodes, sample up
to ``fanout[l]`` in-neighbors per node per layer, with replacement,
building a block-bipartite subgraph per layer. Host-side numpy (the
data-pipeline tier); outputs are padded to powers of two. For the same
graph, seed and sequence of ``sample`` calls the arrays are byte for byte
the reference's: the generator's state carries over between calls, and
the two changes from the reference give identical arrays (the in-edge CSR
from one sort of the ``(dst, src)`` key, whose sources equal those of
``EdgeList.sorted_by_dst``'s ``np.lexsort((src, dst))``; global ids
mapped to table slots by ``np.searchsorted`` over the sorted unique ids
instead of a dict). Build the sampler once per graph: the sort is the
slow part (114.6 M edges at ``minibatch_lg``), and ``from_csr`` rebuilds
a sampler from its ``indptr`` and ``srcs`` without it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.graph.structures import EdgeList


@dataclass
class SampledBlock:
    """One message-passing layer block: edges from src_ids -> dst slots."""

    src_index: np.ndarray  # int32 [E_pad] indices into the layer's node table
    dst_index: np.ndarray  # int32 [E_pad] indices into the next layer's node table
    edge_mask: np.ndarray  # bool  [E_pad]
    n_dst: int


@dataclass
class SampledBatch:
    node_ids: np.ndarray  # int32 [N_pad] global ids of all nodes involved
    node_mask: np.ndarray  # bool [N_pad]
    blocks: List[SampledBlock]
    seed_slots: np.ndarray  # int32 [B] positions of the seed nodes in node_ids


def in_edge_csr(n_nodes: int, src: np.ndarray, dst: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``(indptr int64 [n + 1], srcs int32 [E])``: the in-edges of each
    node, sources ascending (the order of ``np.lexsort((src, dst))``; equal
    (dst, src) pairs have equal sources, so any sort of the key gives the
    same ``srcs``)."""
    key = dst.astype(np.int64) * n_nodes + src.astype(np.int64)
    key.sort()
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=indptr[1:])
    return indptr, (key % n_nodes).astype(np.int32)


class NeighborSampler:
    def __init__(self, edges: EdgeList, fanout: Sequence[int], seed: int = 0):
        self.n = edges.n_nodes
        self.fanout = tuple(fanout)
        # CSR over incoming edges
        self.indptr, self.srcs = in_edge_csr(self.n, edges.src, edges.dst)
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_csr(cls, indptr: np.ndarray, srcs: np.ndarray,
                 fanout: Sequence[int], seed: int = 0) -> "NeighborSampler":
        """A sampler over the CSR ``in_edge_csr`` made, with a new
        generator from ``seed``."""
        self = cls.__new__(cls)
        self.n = len(indptr) - 1
        self.fanout = tuple(fanout)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.srcs = np.asarray(srcs, dtype=np.int32)
        self.rng = np.random.default_rng(seed)
        return self

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        seeds = np.asarray(seeds, dtype=np.int32)
        frontier = seeds
        layers_nodes = [seeds]
        raw_blocks: List[Tuple[np.ndarray, np.ndarray]] = []  # (src_gid, dst_gid)
        for f in self.fanout:
            lo = self.indptr[frontier]
            hi = self.indptr[frontier + 1]
            deg = (hi - lo).astype(np.int64)
            k = np.minimum(deg, f)
            # sample k[i] neighbors for node i, with replacement (standard
            # for SAGE)
            total = int(k.sum())
            dst_rep = np.repeat(frontier, k)
            base = np.repeat(lo, k)
            offs = (self.rng.random(total)
                    * np.repeat(np.maximum(deg, 1), k)).astype(np.int64)
            src_g = self.srcs[base + offs]
            raw_blocks.append((src_g.astype(np.int32),
                               dst_rep.astype(np.int32)))
            frontier = np.unique(src_g).astype(np.int32)
            layers_nodes.append(frontier)

        all_nodes = np.unique(np.concatenate(layers_nodes)).astype(np.int32)

        def remap(g):
            return np.searchsorted(all_nodes, g).astype(np.int32)

        n_pad = _next_pow2(len(all_nodes))
        node_ids = np.zeros(n_pad, dtype=np.int32)
        node_ids[: len(all_nodes)] = all_nodes
        node_mask = np.zeros(n_pad, dtype=bool)
        node_mask[: len(all_nodes)] = True

        blocks = []
        max_e = max((len(s) for s, _ in raw_blocks), default=1)
        e_pad = _next_pow2(max_e)
        # reverse: blocks are applied deepest-first
        for src_g, dst_g in reversed(raw_blocks):
            si = np.zeros(e_pad, dtype=np.int32)
            di = np.zeros(e_pad, dtype=np.int32)
            m = np.zeros(e_pad, dtype=bool)
            if len(src_g):
                si[: len(src_g)] = remap(src_g)
                di[: len(dst_g)] = remap(dst_g)
                m[: len(src_g)] = True
            blocks.append(SampledBlock(si, di, m, n_dst=n_pad))

        seed_slots = remap(seeds)
        return SampledBatch(node_ids, node_mask, blocks, seed_slots)


def _next_pow2(x: int) -> int:
    p = 1
    while p < max(x, 1):
        p <<= 1
    return p

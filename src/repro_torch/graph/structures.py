"""Host-side graph container (numpy), a copy of the JAX package's
``graph/structures.py`` without its device layouts.

``EdgeList`` holds directed edge triples (src, dst, w); undirected graphs
store both directions. All weights are int32 in ``[1, MAX_WEIGHT]`` so the
engine's guarded ``d + w`` never overflows int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

# Largest admissible edge weight / path weight: < 2^30 so d + w fits int32.
MAX_WEIGHT = np.int32(2**30 - 1)


def weight_scale_for(max_weight: int, cap: int = int(MAX_WEIGHT)) -> int:
    """Smallest integer ``s`` with ``ceil(max_weight / s) <= cap``."""
    return max(-(-int(max_weight) // int(cap)), 1)


def rescale_weights(w: np.ndarray, cap: int = int(MAX_WEIGHT)):
    """Ceil-rescale positive integer weights into ``[1, cap]``.

    Returns ``(w_rescaled, scale)`` with ``w_rescaled = ceil(w / scale)``;
    ceiling keeps every rescaled path, times ``scale``, an upper bound.
    """
    w = np.asarray(w, dtype=np.int64)
    wmax = int(w.max()) if len(w) else 0
    scale = weight_scale_for(wmax, cap)
    return np.maximum((w + scale - 1) // scale, 1), scale


@dataclass
class EdgeList:
    """Host-side directed edge list. Undirected graphs carry both directions."""

    n_nodes: int
    src: np.ndarray  # int32 [E]
    dst: np.ndarray  # int32 [E]
    weight: np.ndarray  # int32 [E]

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.weight = np.asarray(self.weight, dtype=np.int32)
        if not (len(self.src) == len(self.dst) == len(self.weight)):
            raise ValueError("src/dst/weight length mismatch")
        if len(self.weight) and (self.weight.min() < 1
                                 or self.weight.max() > MAX_WEIGHT):
            raise ValueError("edge weights must be in [1, 2^30)")

    @property
    def n_edges(self) -> int:
        return len(self.src)

    @staticmethod
    def from_undirected(n_nodes: int, u: np.ndarray, v: np.ndarray,
                        w: np.ndarray) -> "EdgeList":
        """Symmetrize: every undirected {u,v} becomes u->v and v->u."""
        src = np.concatenate([u, v]).astype(np.int32)
        dst = np.concatenate([v, u]).astype(np.int32)
        ww = np.concatenate([w, w]).astype(np.int32)
        return EdgeList(n_nodes, src, dst, ww)

    def sorted_by_dst(self) -> "EdgeList":
        order = np.lexsort((self.src, self.dst))
        return EdgeList(self.n_nodes, self.src[order], self.dst[order],
                        self.weight[order])

    def degrees(self) -> Tuple[np.ndarray, np.ndarray]:
        out = np.bincount(self.src, minlength=self.n_nodes)
        inn = np.bincount(self.dst, minlength=self.n_nodes)
        return out.astype(np.int64), inn.astype(np.int64)

    def remove_self_loops(self) -> "EdgeList":
        keep = self.src != self.dst
        return EdgeList(self.n_nodes, self.src[keep], self.dst[keep],
                        self.weight[keep])

    def coalesce(self) -> "EdgeList":
        """Keep minimum weight among parallel edges."""
        key = self.dst.astype(np.int64) * self.n_nodes + self.src.astype(np.int64)
        order = np.lexsort((self.weight, key))
        key_s = key[order]
        first = np.ones(len(key_s), dtype=bool)
        first[1:] = key_s[1:] != key_s[:-1]
        idx = order[first]
        return EdgeList(self.n_nodes, self.src[idx], self.dst[idx],
                        self.weight[idx])


def to_scipy_csr(edges: EdgeList):
    """scipy CSR matrix of the graph (oracle shortest paths)."""
    import scipy.sparse as sp

    return sp.csr_matrix(
        (edges.weight.astype(np.float64), (edges.src, edges.dst)),
        shape=(edges.n_nodes, edges.n_nodes),
    )

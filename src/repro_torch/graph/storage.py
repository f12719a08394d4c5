"""Mutable edge storage for dynamic graphs, the port of the JAX package's
``graph/storage.py`` (``EdgeStore``; its checkpoint and spill seams and the
partition-aware ``GraphStore`` are not ported yet).

``EdgeStore`` pairs host mirrors (numpy) with int32 device tensors of the
same capacity. Each directed ``(u, v)`` key owns at most one slot; unused
slots are inert self-loops (``0 -> 0, w = 1``, the pooled sessions'
padding), and freed slots are recycled, last freed first, before the
arrays grow. The slot layout is the reference's slot for slot.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import next_multiple, resolve_device
from repro_torch.graph.structures import MAX_WEIGHT, EdgeList

# capacity is a multiple of this, as the reference's EDGE_STORE_BUCKET
EDGE_STORE_BUCKET = 256


class EdgeStore:
    """Paired host/device edge buffers with capacity headroom, built for
    in-place mutation.

    The build drops self-loops and min-coalesces duplicate keys
    (``EdgeList.remove_self_loops().coalesce()``), so a key's slot always
    carries its least weight. Mutations stage on the host (``set_edge``,
    ``delete_edge``) and land on the device in ONE ``index_copy_`` per
    plane per ``flush()``; the arrays are uploaded whole only when the
    capacity grew (``uploads`` counts those, ``scatters`` the in-place
    rounds). Growth doubles the capacity.

    ``min_capacity`` floors the initial capacity (before bucketing).
    """

    def __init__(self, edges: EdgeList, *, headroom: float = 1.5,
                 bucket: int = EDGE_STORE_BUCKET, min_capacity: int = 0,
                 device="cuda"):
        if headroom < 1.0:
            raise ValueError(f"headroom must be >= 1.0, got {headroom}")
        self.device = resolve_device(device)
        self.n_nodes = int(edges.n_nodes)
        self.bucket = int(bucket)
        e = edges.n_edges
        cap = next_multiple(
            max(int(e * headroom), e, int(min_capacity), 1), self.bucket)
        self.h_src = np.zeros(cap, np.int32)
        self.h_dst = np.zeros(cap, np.int32)
        self.h_weight = np.ones(cap, np.int32)
        self.valid = np.zeros(cap, bool)
        self.slot_of: Dict[Tuple[int, int], int] = {}
        clean = edges.remove_self_loops().coalesce()
        k = clean.n_edges
        if k:
            self.h_src[:k] = clean.src
            self.h_dst[:k] = clean.dst
            self.h_weight[:k] = clean.weight
            self.valid[:k] = True
            # the reference's {(u, v): slot} in slot order, built from
            # Python ints in one pass
            self.slot_of = dict(zip(
                zip(clean.src.tolist(), clean.dst.tolist()), range(k)))
        self.free: List[int] = list(range(int(self.valid.sum()), cap))[::-1]
        self._pending: Dict[int, Tuple[int, int, int]] = {}
        self.src: Optional[torch.Tensor] = None
        self.dst: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.uploads = 0   # whole-array device placements (build + growth)
        self.scatters = 0  # in-place scatter rounds (one per flushed batch)
        self._upload()

    def _upload(self) -> None:
        # torch.tensor copies: the device arrays never alias the mirrors
        self.src = torch.tensor(self.h_src, device=self.device)
        self.dst = torch.tensor(self.h_dst, device=self.device)
        self.weight = torch.tensor(self.h_weight, device=self.device)
        self.uploads += 1

    # -- introspection ------------------------------------------------------

    @property
    def capacity(self) -> int:
        return len(self.h_src)

    @property
    def n_edges(self) -> int:
        return int(self.valid.sum())

    def lookup(self, u: int, v: int) -> Optional[int]:
        """Current weight of directed edge (u, v), or None if absent."""
        s = self.slot_of.get((u, v))
        return int(self.h_weight[s]) if s is not None else None

    def edge_list(self) -> EdgeList:
        """Host copy of the REAL (valid) edges, in slot order."""
        m = self.valid
        return EdgeList(self.n_nodes, self.h_src[m].copy(),
                        self.h_dst[m].copy(), self.h_weight[m].copy())

    # -- staged mutation ----------------------------------------------------

    def _check_endpoint(self, u: int, v: int) -> None:
        n = self.n_nodes
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(f"edge ({u}, {v}) out of range for {n} nodes")

    def set_edge(self, u: int, v: int, w: int) -> None:
        """Stage insert-or-reweight of directed edge (u, v) to weight w."""
        self._check_endpoint(u, v)
        if not (1 <= w <= int(MAX_WEIGHT)):
            raise ValueError(f"edge weights must be in [1, 2^30), got {w}")
        s = self.slot_of.get((u, v))
        if s is None:
            if not self.free:
                self._grow(self.capacity + 1)
            s = self.free.pop()
            self.slot_of[(u, v)] = s
            self.valid[s] = True
        self.h_src[s], self.h_dst[s], self.h_weight[s] = u, v, w
        self._pending[s] = (u, v, w)

    def delete_edge(self, u: int, v: int) -> None:
        """Stage removal of directed edge (u, v): the slot reverts to an
        inert self-loop and is recycled for later insertions."""
        s = self.slot_of.pop((u, v), None)
        if s is None:
            raise ValueError(f"cannot delete missing edge ({u}, {v})")
        self.valid[s] = False
        self.free.append(s)
        self.h_src[s], self.h_dst[s], self.h_weight[s] = 0, 0, 1
        self._pending[s] = (0, 0, 1)

    def _grow(self, min_capacity: int) -> None:
        cap = next_multiple(max(min_capacity, 2 * self.capacity), self.bucket)
        pad = cap - self.capacity
        self.free = list(range(self.capacity, cap))[::-1] + self.free
        self.h_src = np.concatenate([self.h_src, np.zeros(pad, np.int32)])
        self.h_dst = np.concatenate([self.h_dst, np.zeros(pad, np.int32)])
        self.h_weight = np.concatenate([self.h_weight, np.ones(pad, np.int32)])
        self.valid = np.concatenate([self.valid, np.zeros(pad, bool)])

    def flush(self) -> bool:
        """Land the staged mutations on the device. Returns True when the
        device arrays were REPLACED (the capacity grew: one whole upload);
        False means one in-place ``index_copy_`` per plane (or nothing
        staged). Either way the caller rebinds its views."""
        self.ensure_device()
        grew = len(self.h_src) != int(self.src.shape[0])
        if grew:
            self._upload()
        elif self._pending:
            slots = torch.from_numpy(np.fromiter(
                self._pending, np.int64, count=len(self._pending)))
            svw = torch.from_numpy(np.array(list(self._pending.values()),
                                            np.int32))
            slots, svw = slots.to(self.device), svw.to(self.device)
            self.src.index_copy_(0, slots, svw[:, 0])
            self.dst.index_copy_(0, slots, svw[:, 1])
            self.weight.index_copy_(0, slots, svw[:, 2])
            self.scatters += 1
        self._pending.clear()
        return grew

    def ensure_device(self) -> None:
        """Upload the mirrors when the device arrays are absent; no-op
        when resident."""
        if self.src is None:
            self._upload()

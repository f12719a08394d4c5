"""Edge storage, the port of the JAX package's ``graph/storage.py``.

  * ``EdgeStore`` pairs host mirrors (numpy) with int32 device tensors of
    the same capacity. Each directed ``(u, v)`` key owns at most one slot;
    unused slots are inert self-loops (``0 -> 0, w = 1``, the pooled
    sessions' padding), and freed slots are recycled, last freed first,
    before the arrays grow. The slot layout is the reference's slot for
    slot. Its checkpoint seam (``state_dict``/``extra_state``/
    ``load_state``/``from_state``) and spill seam (``drop_device``/
    ``ensure_device``) let a session persist the buffers and give back
    the device memory.
  * ``GraphStore`` adds the partition-aware layout of the paper's
    linear-local-space regime: the graph relabeled ONCE by the
    cluster-locality permutation (``graph/partition.py``) when pilot
    ``centers`` are given, destination-owned per-shard slabs, the halo
    index (the remote source rows each shard reads), and optional
    compressed residency (``runtime/compression.pack_i32``, exact).

The halo plan is static, so its wire bytes (``halo_bytes_per_superstep``
and the full-plane baseline) are exact numbers that cost no read. The
port has one device and no sharded backend: ``sharded_graph`` raises
until multi-device execution is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common import next_multiple, resolve_device, to_device
from repro_torch.graph.partition import apply_partition, cluster_partition
from repro_torch.graph.structures import MAX_WEIGHT, EdgeList
from repro_torch.runtime.compression import PackedI32, pack_i32, unpack_i32

# capacity is a multiple of this, as the reference's EDGE_STORE_BUCKET
EDGE_STORE_BUCKET = 256

# six int32 plane rows exchanged per node row per superstep under the
# reference's sharded relay layout (the halo's wire-byte unit)
PLANE_ROW_BYTES = 6 * 4


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
        self._count_in_degrees()
        self._pending: Dict[int, Tuple[int, int, int]] = {}
        self.src: Optional[torch.Tensor] = None
        self.dst: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.uploads = 0   # whole-array device placements (build + growth)
        self.scatters = 0  # in-place scatter rounds (one per flushed batch)
        self._upload()

    def _count_in_degrees(self) -> None:
        """``in_degree``: each node's valid in-edges other than self-loops
        (the rows of the kernel backend's CSR), kept up to date by
        ``set_edge`` and ``delete_edge``, so a rebind reads no row length
        back from the card."""
        live = self.valid & (self.h_src != self.h_dst)
        self.in_degree = np.bincount(self.h_dst[live],
                                     minlength=self.n_nodes).astype(np.int64)

    def _upload(self) -> None:
        # to_device copies: the device arrays never alias the mirrors
        self.src = to_device(self.h_src, self.device)
        self.dst = to_device(self.h_dst, self.device)
        self.weight = to_device(self.h_weight, self.device)
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
            self.in_degree[v] += u != v
        self.h_src[s], self.h_dst[s], self.h_weight[s] = u, v, w
        self._pending[s] = (u, v, w)

    def delete_edge(self, u: int, v: int) -> None:
        """Stage removal of directed edge (u, v): the slot reverts to an
        inert self-loop and is recycled for later insertions."""
        s = self.slot_of.pop((u, v), None)
        if s is None:
            raise ValueError(f"cannot delete missing edge ({u}, {v})")
        self.valid[s] = False
        self.in_degree[v] -= u != v
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
            slots = to_device(np.fromiter(
                self._pending, np.int64, count=len(self._pending)),
                self.device)
            svw = to_device(np.array(list(self._pending.values()), np.int32),
                            self.device)
            self.src.index_copy_(0, slots, svw[:, 0])
            self.dst.index_copy_(0, slots, svw[:, 1])
            self.weight.index_copy_(0, slots, svw[:, 2])
            self.scatters += 1
        self._pending.clear()
        return grew

    # -- spill seam ---------------------------------------------------------

    def drop_device(self) -> None:
        """Release the device arrays (a session's spill). The host mirrors
        stay the source of truth; ``ensure_device()`` uploads again."""
        self.src = self.dst = self.weight = None

    def device_bytes(self) -> int:
        """Bytes of the device edge arrays, inert slots included (0 when
        spilled): what both backends read, whatever the host slabs hold."""
        if self.src is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (self.src, self.dst, self.weight))

    def ensure_device(self) -> None:
        """Upload the mirrors when the device arrays are absent (counted in
        ``uploads``); no-op when resident."""
        if self.src is None:
            self._upload()

    # -- checkpoint seam ----------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The host buffers as a flat tree for ``checkpoint.save``, at full
        capacity, with the free list IN ITS ORDER (slots recycle last freed
        first, so replaying an update stream after a restore lands the
        edges in the same slots). ``slot_of`` is rebuilt on load."""
        return {
            "h_src": self.h_src.copy(),
            "h_dst": self.h_dst.copy(),
            "h_weight": self.h_weight.copy(),
            "valid": self.valid.copy(),
            "free": np.asarray(self.free, np.int64),
        }

    def extra_state(self) -> Dict[str, Any]:
        """JSON scalars for the checkpoint's manifest."""
        return {"kind": type(self).__name__, "n_nodes": self.n_nodes,
                "bucket": self.bucket, "capacity": self.capacity}

    def load_state(self, tree: Dict[str, np.ndarray],
                   extra: Dict[str, Any]) -> None:
        """Restore the host and device buffers in place from a
        ``state_dict`` round trip (one whole upload). Staged mutations are
        dropped: the checkpoint is the durable truth."""
        if int(extra["n_nodes"]) != self.n_nodes:
            raise ValueError(
                f"checkpoint is for n_nodes={extra['n_nodes']}, "
                f"store has n_nodes={self.n_nodes}")
        self.bucket = int(extra.get("bucket", self.bucket))
        self.h_src = np.asarray(tree["h_src"], np.int32).copy()
        self.h_dst = np.asarray(tree["h_dst"], np.int32).copy()
        self.h_weight = np.asarray(tree["h_weight"], np.int32).copy()
        self.valid = np.asarray(tree["valid"], bool).copy()
        self.free = [int(s) for s in np.asarray(tree["free"])]
        self._count_in_degrees()
        live = np.flatnonzero(self.valid)
        self.slot_of = dict(zip(
            zip(self.h_src[live].tolist(), self.h_dst[live].tolist()),
            live.tolist()))
        self._pending = {}
        self._upload()

    @classmethod
    def from_state(cls, tree: Dict[str, np.ndarray], extra: Dict[str, Any],
                   device="cuda") -> "EdgeStore":
        """A store rebuilt from a checkpoint, without the original edges,
        on ``device``."""
        store = cls.__new__(cls)
        store.device = resolve_device(device)
        store.n_nodes = int(extra["n_nodes"])
        store.bucket = int(extra.get("bucket", EDGE_STORE_BUCKET))
        store.uploads = 0
        store.scatters = 0
        store._init_subclass_blank(extra)
        store.load_state(tree, extra)
        return store

    def _init_subclass_blank(self, extra: Dict[str, Any]) -> None:
        """Hook: a subclass sets its own attributes here before
        ``load_state`` runs in :meth:`from_state`."""


# ---------------------------------------------------------------------------
# partition-aware sharded storage
# ---------------------------------------------------------------------------


@dataclass
class EdgeSlab:
    """One shard's edge columns, (dst, src)-sorted, with GLOBAL (relabeled)
    node ids: raw int32 arrays, or :class:`PackedI32` streams when
    ``compressed``."""

    shard: int
    n_edges: int
    src: Union[np.ndarray, PackedI32]
    dst: Union[np.ndarray, PackedI32]
    weight: Union[np.ndarray, PackedI32]
    compressed: bool

    @property
    def nbytes(self) -> int:
        return sum(int(c.nbytes) for c in (self.src, self.dst, self.weight))


class GraphStore(EdgeStore):
    """``EdgeStore`` plus per-shard slabs, a halo index and optional
    compressed residency.

    With pilot ``centers`` and more than one shard, the build relabels the
    graph ONCE through ``cluster_partition``, so whole clusters land on one
    shard; every consumer then sees the RELABELED ids, and ``perm`` (new ->
    old) / ``inv_perm`` (old -> new) map back. Without centers the split is
    the contiguous range partition and the ids are the caller's.

    Slabs are destination-owned (``owner(v) = v // nodes_per_shard``) and
    built lazily from the valid edges; a mutation drops them (and the halo
    index), and the next read builds them again. With ``compress=True``
    the slab columns rest as ``pack_i32`` streams and :meth:`slab` unpacks
    on demand (``decompressions`` counts those).
    """

    def __init__(self, edges: EdgeList, *, n_shards: int = 1,
                 centers: Optional[np.ndarray] = None,
                 compress: bool = False, headroom: float = 1.5,
                 bucket: int = EDGE_STORE_BUCKET, min_capacity: int = 0,
                 device="cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.compress = bool(compress)
        self.perm: Optional[np.ndarray] = None
        self.inv_perm: Optional[np.ndarray] = None
        if centers is not None and self.n_shards > 1 and edges.n_nodes:
            perm = cluster_partition(np.asarray(centers), self.n_shards)
            edges, inv = apply_partition(edges, perm)
            self.perm = np.asarray(perm, np.int32)
            self.inv_perm = np.asarray(inv, np.int32)
        super().__init__(edges, headroom=headroom, bucket=bucket,
                         min_capacity=min_capacity, device=device)
        self.decompressions = 0
        self._slabs: Optional[List[EdgeSlab]] = None
        self._halo: Optional[Dict[int, np.ndarray]] = None
        self._halo_k: Optional[int] = None

    # -- shard geometry -----------------------------------------------------

    @property
    def n_pad(self) -> int:
        """Node count padded to a multiple of ``n_shards``."""
        return next_multiple(self.n_nodes, self.n_shards)

    @property
    def nodes_per_shard(self) -> int:
        return self.n_pad // self.n_shards if self.n_shards else 0

    def shard_of(self, node):
        """Owner shard of a (relabeled) node id: the destination rule."""
        return node // max(self.nodes_per_shard, 1)

    # -- mutation drops the derived layout -----------------------------------

    def _invalidate(self) -> None:
        self._slabs = None
        self._halo = None
        self._halo_k = None

    def set_edge(self, u: int, v: int, w: int) -> None:
        super().set_edge(u, v, w)
        self._invalidate()

    def delete_edge(self, u: int, v: int) -> None:
        super().delete_edge(u, v)
        self._invalidate()

    def flush(self) -> bool:
        grew = super().flush()
        if grew:
            self._invalidate()
        return grew

    # -- slabs and halo index -----------------------------------------------

    def _build_layout(self) -> None:
        e = self.edge_list().sorted_by_dst()
        q = max(self.nodes_per_shard, 1)
        owner = e.dst // q
        slabs: List[EdgeSlab] = []
        halo: Dict[int, np.ndarray] = {}
        k_max = 0
        for p in range(self.n_shards):
            m = owner == p
            src, dst, w = e.src[m], e.dst[m], e.weight[m]
            remote = np.unique(src[src // q != p]).astype(np.int32)
            halo[p] = remote
            if remote.size:
                # the static plan's width: the LARGEST per-pair count of
                # unique sources (every pair ships K rows)
                per_pair = np.bincount(remote // q, minlength=self.n_shards)
                k_max = max(k_max, int(per_pair.max()))
            if self.compress:
                slabs.append(EdgeSlab(p, int(src.size), pack_i32(src),
                                      pack_i32(dst), pack_i32(w), True))
            else:
                slabs.append(EdgeSlab(p, int(src.size), src, dst, w, False))
        self._slabs = slabs
        self._halo = halo
        self._halo_k = k_max

    def slabs(self) -> List[EdgeSlab]:
        """The per-shard slabs (built on first use, compressed or not)."""
        if self._slabs is None:
            self._build_layout()
        return self._slabs

    def slab(self, p: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Shard ``p``'s ``(src, dst, weight)`` as int32 arrays, unpacked
        on demand under compressed residency."""
        s = self.slabs()[p]
        if not s.compressed:
            return s.src, s.dst, s.weight
        self.decompressions += 1
        return unpack_i32(s.src), unpack_i32(s.dst), unpack_i32(s.weight)

    def halo_index(self) -> Dict[int, np.ndarray]:
        """shard -> sorted unique REMOTE source ids whose plane rows that
        shard reads: every source of a shard's slab is owner-local or
        listed here."""
        if self._halo is None:
            self._build_layout()
        return self._halo

    def halo_rows(self) -> int:
        """Boundary rows over all shards (the unpadded halo)."""
        return sum(int(v.size) for v in self.halo_index().values())

    def halo_k(self) -> int:
        """The static plan's width: the most unique sources any (owner,
        reader) pair of shards exchanges."""
        if self._halo_k is None:
            self._build_layout()
        return self._halo_k

    # -- wire-byte accounting (static plan) ----------------------------------

    def halo_bytes_per_superstep(self) -> int:
        """Plane-row bytes one superstep moves under the static halo plan:
        every shard ships an ``[n_shards, K]`` table of six int32 planes."""
        p = self.n_shards
        if p <= 1:
            return 0
        return PLANE_ROW_BYTES * p * p * self.halo_k()

    def fullplane_bytes_per_superstep(self) -> int:
        """The full-plane all-gather baseline: every shard receives all
        ``n_pad`` rows of the six planes each superstep."""
        p = self.n_shards
        if p <= 1:
            return 0
        return PLANE_ROW_BYTES * self.n_pad * p

    def resident_bytes(self) -> int:
        """Bytes the slabs hold at rest (compressed when enabled)."""
        return sum(s.nbytes for s in self.slabs())

    def raw_bytes(self) -> int:
        """The slabs' uncompressed size: 3 int32 columns an edge."""
        return sum(3 * 4 * s.n_edges for s in self.slabs())

    # -- sharded-execution handoff ------------------------------------------

    def sharded_graph(self, build_halo: bool = True):
        """The reference hands this layout to its ``DistributedEngine``;
        the port has one device and no sharded backend yet."""
        raise NotImplementedError(
            "GraphStore.sharded_graph feeds a sharded backend, which waits "
            "for multi-device execution (ROADMAP §1 item 7); on one "
            "device the store backs the single and kernel backends")

    # -- checkpoint seam ----------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        tree = super().state_dict()
        # always present (the identity when not relabeled), so a checkpoint
        # tree has one structure whatever store reads it
        tree["perm"] = (self.perm.copy() if self.perm is not None
                        else np.arange(self.n_nodes, dtype=np.int32))
        return tree

    def extra_state(self) -> Dict[str, Any]:
        d = super().extra_state()
        d.update(n_shards=self.n_shards, compress=self.compress,
                 partitioned=self.perm is not None)
        return d

    def load_state(self, tree: Dict[str, np.ndarray],
                   extra: Dict[str, Any]) -> None:
        if "n_shards" in extra and int(extra["n_shards"]) != self.n_shards:
            raise ValueError(
                f"checkpoint has n_shards={extra['n_shards']}, "
                f"store has n_shards={self.n_shards}")
        super().load_state(tree, extra)
        if extra.get("partitioned"):
            self.perm = np.asarray(tree["perm"], np.int32).copy()
            inv = np.empty_like(self.perm)
            inv[self.perm] = np.arange(len(self.perm), dtype=np.int32)
            self.inv_perm = inv
        self._invalidate()

    def _init_subclass_blank(self, extra: Dict[str, Any]) -> None:
        self.n_shards = int(extra.get("n_shards", 1))
        self.compress = bool(extra.get("compress", False))
        self.perm = None
        self.inv_perm = None
        self.decompressions = 0
        self._invalidate()

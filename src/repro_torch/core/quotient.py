"""Quotient graph construction and local diameter solve (paper Section 4),
the port of the JAX package's ``core/quotient.py``.

Nodes of G_C are clusters; for each edge (u, v) with c_u != c_v the
quotient edge weight is ``w(u,v) + pathw(u) + pathw(v)`` (int64; the
realized path weights upper-bound the distances, so the estimate stays
conservative). Parallel edges keep the minimum.

  * ``_quotient_kernel`` — cross-edge detection, (cluster, cluster) key
    sort and coalescing by the lexicographic tuple-min, on the backend's
    device edge arrays, with no host read. ``jnp.unique(size=n,
    fill_value=n)`` becomes a presence mask + prefix sum (same sorted
    labels and fill, and fixed-size, so no implicit sync);
    ``jnp.lexsort((wq, key))`` becomes a stable sort by ``wq`` followed by
    a stable sort by ``key``.
  * ``_solve_kernel`` — batched multi-source Bellman-Ford from ALL
    clusters (``sssp.batched_bf_loop``), int32 when ``k_pad * max_weight``
    fits, int64 otherwise; one packed (diameter, connected, steps, ecc)
    read.

Cascade levels re-enter the engine on a quotient: ``quotient_as_edgelist``
rewrites a ``DeviceQuotient`` in the engine's int32 edge layout on the
device (``QuotientLevel``), and ``build_quotient_from_level`` takes the
next quotient of a level's decomposition.

``build_quotient_numpy``, ``quotient_diameter`` (scipy) and
``quotient_diameter_minplus`` (int64 min-plus squaring) are the host
oracles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import next_multiple
from repro_torch.core.chunked import DEFAULT_CHUNK
from repro_torch.core.engine import Decomposition
from repro_torch.core.sssp import INF32, batched_bf_loop
from repro_torch.graph.segment_ops import segment_min_triple
from repro_torch.graph.structures import MAX_WEIGHT, EdgeList, weight_scale_for

# Unreached sentinel for the int64 solve; guarded adds stay < 2^63.
INF64 = 2**62
# k is padded to a multiple of this (and m to a multiple of 8x), as the
# reference does for its compile buckets; kept so the padded shapes match.
K_BUCKET = 16
# cascade levels slice the quotient edge arrays to a multiple of this, as
# the reference does for its compile buckets, so a level graph is the same
# array (inert self-loops included) that the reference decomposes
LEVEL_EDGE_BUCKET = 256


@dataclass
class QuotientGraph:
    n_clusters: int
    center_ids: np.ndarray  # original node id of each quotient node
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray      # int64 (sums of three int32 terms)


@dataclass
class DeviceQuotient:
    """Device-resident quotient: [E]-length arrays + 0-dim counters.

    Edges are sorted by (cluster, cluster) key with the first ``n_edges``
    slots valid; invalid slots carry a weight >= INF64.
    """

    centers: torch.Tensor     # int32 [n], first n_clusters slots valid
    src: torch.Tensor         # int32 [E] compact cluster labels
    dst: torch.Tensor         # int32 [E]
    weight: torch.Tensor      # int64 [E]
    n_clusters: torch.Tensor  # int64 0-dim
    n_edges: torch.Tensor     # int64 0-dim
    max_weight: torch.Tensor  # int64 0-dim (pre-coalesce max cross weight)
    weight_sum: torch.Tensor  # int64 0-dim (sum of coalesced weights)


def build_quotient_numpy(edges: EdgeList, dec: Decomposition) -> QuotientGraph:
    """Host numpy reference (the parity oracle for the device pass)."""
    centers, inverse = np.unique(dec.final_c, return_inverse=True)
    k = len(centers)
    cu = inverse[edges.src]
    cv = inverse[edges.dst]
    cross = cu != cv
    cu, cv = cu[cross], cv[cross]
    wq = (
        edges.weight[cross].astype(np.int64)
        + dec.final_pathw[edges.src[cross]].astype(np.int64)
        + dec.final_pathw[edges.dst[cross]].astype(np.int64)
    )
    key = cu.astype(np.int64) * k + cv.astype(np.int64)
    order = np.lexsort((wq, key))
    key_s = key[order]
    first = np.ones(len(key_s), dtype=bool)
    if len(key_s):
        first[1:] = key_s[1:] != key_s[:-1]
    idx = order[first]
    return QuotientGraph(
        n_clusters=k,
        center_ids=centers,
        src=cu[idx].astype(np.int32),
        dst=cv[idx].astype(np.int32),
        weight=wq[idx],
    )


def _unique_padded(final_c: torch.Tensor, n: int):
    """``jnp.unique(final_c, size=n, fill_value=n, return_inverse=True)``
    for labels in [0, n): (sorted labels padded with n, inverse, count)."""
    dev = final_c.device
    lab = final_c.to(torch.int64)
    present = torch.zeros(n, dtype=torch.bool, device=dev)
    present[lab] = True
    rank = torch.cumsum(present.to(torch.int64), 0) - 1
    slot = torch.where(present, rank, n)    # absent labels go to slot n
    centers = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    centers.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=dev))
    return centers[:n], rank[lab], present.sum()


def _quotient_kernel(src, dst, w, final_c, final_pathw, *,
                     n: int) -> DeviceQuotient:
    """Cross-edge detect -> key sort -> coalesce; no host read.

    ``src``/``dst`` are real node ids in [0, n): the port's backends hold
    no padding edges.
    """
    E = int(src.shape[0])
    dev = src.device
    centers, inverse, k = _unique_padded(final_c, n)
    su = src.to(torch.int64)
    sv = dst.to(torch.int64)
    cu = inverse[su].to(torch.int32)
    cv = inverse[sv].to(torch.int32)
    cross = cu != cv
    fp = final_pathw.to(torch.int64)
    wq = w.to(torch.int64) + fp[su] + fp[sv]  # dtype: int64 sum of three int32 terms cannot wrap
    wq = torch.where(cross, wq, INF64)
    key = torch.where(cross, cu.to(torch.int64) * (n + 1) + cv.to(torch.int64),
                      INF64)
    # jnp.lexsort((wq, key)): stable sort by the minor key, then the major
    order = torch.sort(wq, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    key_s, wq_s = key[order], wq[order]
    cu_s, cv_s = cu[order], cv[order]
    valid_s = key_s < INF64
    first = valid_s.clone()
    first[1:] &= key_s[1:] != key_s[:-1]
    seg = torch.clamp(torch.cumsum(first.to(torch.int64), 0) - 1, 0,
                      max(E - 1, 0))
    # coalesce parallel (cluster, cluster) edges with the lexicographic
    # tuple-min (cu/cv are constant inside a segment)
    q_w, q_src, q_dst = segment_min_triple(
        torch.where(valid_s, wq_s, INF64),
        torch.where(valid_s, cu_s, n).to(torch.int32),
        torch.where(valid_s, cv_s, n).to(torch.int32),
        seg, max(E, 1),
    )
    q_w = q_w[:E]
    return DeviceQuotient(
        centers=centers,
        src=q_src[:E], dst=q_dst[:E], weight=q_w,
        n_clusters=k, n_edges=first.sum(),
        max_weight=torch.max(torch.where(cross, wq, 0)) if E else
        torch.zeros((), dtype=torch.int64, device=dev),
        weight_sum=torch.sum(torch.where(q_w < INF64, q_w, 0)),
    )


def fetch_quotient_counters(dq: DeviceQuotient) -> Tuple[int, int, int, int]:
    """ONE packed host read of ``(n_clusters, n_edges, max_weight,
    weight_sum)``. Callers account the sync themselves."""
    kmws = guard.fetch(torch.stack([
        dq.n_clusters.to(torch.int64), dq.n_edges.to(torch.int64),
        dq.max_weight.to(torch.int64), dq.weight_sum.to(torch.int64)]),
        reason="quotient: packed (k, m, wmax, wsum) counters")
    return int(kmws[0]), int(kmws[1]), int(kmws[2]), int(kmws[3])


def _decomposition_planes(dec: Decomposition, n: int, device):
    fc = (dec.final_c_dev if dec.final_c_dev is not None
          else torch.as_tensor(dec.final_c))
    fp = (dec.final_pathw_dev if dec.final_pathw_dev is not None
          else torch.as_tensor(dec.final_pathw))
    return fc[:n].to(device), fp[:n].to(device)


def build_quotient_device(edges: EdgeList, dec: Decomposition,
                          backend) -> Optional[DeviceQuotient]:
    """Run the quotient pass on the backend's device edge arrays. Returns
    None for graphs with no nodes or no edges. No host read."""
    n = edges.n_nodes
    if n == 0 or edges.n_edges == 0:
        return None
    src, dst, w = backend.flat_edges()
    fc, fp = _decomposition_planes(dec, n, src.device)
    return _quotient_kernel(src, dst, w, fc, fp, n=n)


# ---------------------------------------------------------------------------
# incremental refresh: recompute only the keys touching dirty clusters
# ---------------------------------------------------------------------------


def _merge_quotient_kernel(cs, cd, cw, fs, fd, fw, dirty_compact, *, n: int):
    """Merge a cached quotient's CLEAN entries with fresh entries.

    ``dirty_compact`` is a bool [n] mask over compact cluster labels. Every
    cached entry touching a dirty cluster is dropped; the fresh entries
    (``_quotient_kernel`` over the dirty-incident edges) cover all such
    pairs, so the two sets are disjoint and one stable key sort restores
    the sorted-key invariant. Returns (src, dst, w, n_edges, max_weight,
    weight_sum), the counters as 0-dim int64 tensors."""
    drop = (dirty_compact[torch.clamp(cs, 0, n - 1).to(torch.int64)]
            | dirty_compact[torch.clamp(cd, 0, n - 1).to(torch.int64)])
    keep = (cw < INF64) & ~drop
    src = torch.cat([torch.where(keep, cs, n).to(torch.int32), fs])
    dst = torch.cat([torch.where(keep, cd, n).to(torch.int32), fd])
    w = torch.cat([torch.where(keep, cw, INF64), fw])
    valid = w < INF64
    key = torch.where(
        valid, src.to(torch.int64) * (n + 1) + dst.to(torch.int64), INF64)
    order = torch.sort(key, stable=True).indices
    src, dst, w = src[order], dst[order], w[order]
    valid = w < INF64
    return (src, dst, w, valid.sum(),
            torch.max(torch.where(valid, w, 0)),
            torch.sum(torch.where(valid, w, 0)))


def quotient_update_device(
    cached: DeviceQuotient,
    m_cached: int,
    dirty_edges: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    final_c_dev: torch.Tensor,
    final_pathw_dev: torch.Tensor,
    dirty_center_ids: np.ndarray,
    n: int,
) -> DeviceQuotient:
    """Incremental quotient refresh: only the (cluster, cluster) keys that
    touch a dirty cluster are recomputed, by ``_quotient_kernel`` over
    ``dirty_edges`` (the dirty-incident slice; its padding is inert
    ``0 -> 0`` self-loops, never cross edges); the cached quotient gives
    every clean pair. Sound only when the cluster set equals the cached
    build's (the caller rebuilds the quotient when it changed)."""
    fresh = _quotient_kernel(*dirty_edges, final_c_dev, final_pathw_dev, n=n)
    dirty_node = np.zeros(n + 1, bool)
    dirty_node[np.asarray(dirty_center_ids, np.int64)] = True
    # centers[i] is the i-th cluster's center (n on padding slots)
    dirty_compact = torch.from_numpy(dirty_node).to(
        cached.centers.device)[cached.centers.to(torch.int64)]
    m_pad = min(next_multiple(max(m_cached, 1), K_BUCKET * 8),
                int(cached.src.shape[0]))
    src, dst, w, n_q, wmax, wsum = _merge_quotient_kernel(
        cached.src[:m_pad], cached.dst[:m_pad], cached.weight[:m_pad],
        fresh.src, fresh.dst, fresh.weight, dirty_compact, n=n)
    return DeviceQuotient(
        centers=cached.centers, src=src, dst=dst, weight=w,
        n_clusters=cached.n_clusters, n_edges=n_q, max_weight=wmax,
        weight_sum=wsum)


# ---------------------------------------------------------------------------
# cascade levels: re-enter the engine on the quotient itself
# ---------------------------------------------------------------------------


class QuotientLevel(NamedTuple):
    """A ``DeviceQuotient`` in the engine's edge layout: flat int32 device
    arrays over ``n_nodes = k`` compact cluster labels, padding slots
    rewritten as inert self-loops (0 -> 0, w = 1).

    Quotient weights are int64 sums and the engine's planes int32, so
    weights are rescaled by ``scale`` with ceiling division (conservative:
    ``scale * dist_rescaled >= dist_true`` for every pair, so upper bounds
    survive the cascade); ``scale`` is 1 whenever the level fits int32.
    """

    n_nodes: int           # k (host)
    n_edges: int           # real quotient edge count m (host)
    src: torch.Tensor      # int32 [e_pad]
    dst: torch.Tensor      # int32 [e_pad]
    weight: torch.Tensor   # int32 [e_pad], ceil(w / scale); 1 on padding
    scale: int             # original units = scale * level units
    weight_sum: int        # upper bound on sum(weight) in level units

    def to_edgelist(self) -> EdgeList:
        """Host copy of the first ``n_edges`` slots (the coalesced quotient
        edges), for tests and oracles."""
        m = self.n_edges
        return EdgeList(self.n_nodes, self.src[:m].cpu().numpy(),
                        self.dst[:m].cpu().numpy(),
                        self.weight[:m].cpu().numpy())


def _level_edges_kernel(src, dst, w, scale: int):
    """Valid slots keep their endpoints with the ceil-rescaled int32
    weight; invalid slots (weight >= INF64, the empty-segment int64 max
    among them) become inert self-loops."""
    valid = w < INF64
    w32 = torch.where(valid, torch.div(w + (scale - 1), scale,
                                       rounding_mode="floor"), 1)
    w32 = torch.clamp(w32, 1, int(MAX_WEIGHT)).to(torch.int32)
    s = torch.where(valid, src, 0).to(torch.int32)
    t = torch.where(valid, dst, 0).to(torch.int32)
    return s, t, w32


def quotient_as_edgelist(
    dq: DeviceQuotient, k: int, m: int, max_weight: int, weight_sum: int = 0,
    *, edge_bucket: int = LEVEL_EDGE_BUCKET,
) -> QuotientLevel:
    """``DeviceQuotient`` -> the engine's edge layout, on the device (the
    ``(k, m, max_weight, weight_sum)`` counters must already be read).

    The arrays are sliced to ``e_pad``, a multiple of ``edge_bucket`` capped
    at the quotient's length E. ``weight_sum`` (level units) is the
    ceil-sum bound ``sum(ceil(w / s)) <= sum(w) / s + m``.
    """
    scale = weight_scale_for(max_weight)
    E = int(dq.src.shape[0])
    e_pad = min(next_multiple(max(m, 1), edge_bucket), max(E, 1))
    src, dst, w32 = _level_edges_kernel(dq.src[:e_pad], dq.dst[:e_pad],
                                        dq.weight[:e_pad], scale)
    return QuotientLevel(n_nodes=k, n_edges=m, src=src, dst=dst, weight=w32,
                         scale=scale, weight_sum=int(weight_sum) // scale + m)


def build_quotient_from_level(level: QuotientLevel,
                              dec: Decomposition) -> DeviceQuotient:
    """The next cascade level: the quotient pass over a level's device edge
    arrays and its decomposition's planes. Padding self-loops are never
    cross edges. No host read."""
    fc, fp = _decomposition_planes(dec, level.n_nodes, level.src.device)
    return _quotient_kernel(level.src, level.dst, level.weight, fc, fp,
                            n=level.n_nodes)


def _solve_kernel(qsrc, qdst, qw, k: int, *, k_pad: int,
                  chunk: int = DEFAULT_CHUNK):
    """Exact APSP on the quotient via Bellman-Ford from all ``k_pad``
    sources at once (distances laid out [node, source]). The distance dtype
    follows ``qw``. Returns (packed int64 [3 + k_pad] =
    [diameter, connected, supersteps, ecc...], chunk reads)."""
    inf = INF64 if qw.dtype == torch.int64 else INF32
    dev = qw.device
    s = torch.clamp(qsrc, 0, k_pad - 1).to(torch.int32)
    t = torch.clamp(qdst, 0, k_pad - 1).to(torch.int32)
    eye = torch.eye(k_pad, dtype=torch.bool, device=dev)
    d0 = torch.where(eye, torch.zeros((), dtype=qw.dtype, device=dev),
                     torch.full((), inf, dtype=qw.dtype, device=dev))
    d, steps, reads = batched_bf_loop(s, t, qw, d0, inf, k_pad, chunk)
    node_ok = torch.arange(k_pad, device=dev) < k
    pair_ok = node_ok[:, None] & node_ok[None, :]
    finite = pair_ok & (d < inf)
    connected = finite.sum() == k * k
    d_fin = torch.where(finite, d, 0).to(torch.int64)
    ecc = torch.amax(d_fin, dim=0)   # [node, source]: reduce over nodes
    head = torch.stack([d_fin.max(), connected.to(torch.int64),
                        torch.tensor(steps, dtype=torch.int64, device=dev)])
    return torch.cat([head, ecc]), reads


@dataclass
class SolveResult:
    diameter: int
    ecc: np.ndarray       # int64 [k] eccentricity of each cluster
    connected: bool
    supersteps: int
    reads: int            # host reads (chunk reads + the packed result)
    dtype: str            # distance dtype of the solve: int32 | int64


def solve_device_quotient(dq: DeviceQuotient, k: int, m: int,
                          max_weight: int = 0,
                          chunk: int = DEFAULT_CHUNK) -> SolveResult:
    """Solve a device quotient whose counters have been fetched.

    When ``k_pad * max_weight < 2^31 - 1`` the solve runs in int32: every
    shortest path has < k edges, so distances and guarded adds fit.
    """
    if k <= 1:
        return SolveResult(0, np.zeros(k, np.int64), True, 0, 0, "int64")
    k_pad = next_multiple(k, K_BUCKET)
    E = int(dq.src.shape[0])
    m_pad = min(next_multiple(max(m, 1), 8 * K_BUCKET), E)
    int32_safe = k_pad * max(int(max_weight), 1) < 2**31 - 1
    qw = dq.weight[:m_pad]
    if int32_safe:
        # invalid (padding) slots carry >= INF64: map onto the int32 INF
        qw = torch.where(qw >= INF64, INF32, qw).to(torch.int32)
    packed, reads = _solve_kernel(dq.src[:m_pad], dq.dst[:m_pad], qw, k,
                                  k_pad=k_pad, chunk=chunk)
    out = guard.fetch(
        packed, reason="quotient solve: packed (diam, connected, steps, ecc)")
    return SolveResult(int(out[0]), out[3:3 + k], bool(out[1]), int(out[2]),
                       reads + 1, str(qw.dtype).split(".")[-1])


def quotient_diameter(q: QuotientGraph) -> Tuple[int, bool]:
    """Exact weighted diameter of the quotient (scipy test oracle)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    if q.n_clusters <= 1:
        return 0, True
    m = sp.csr_matrix(
        (q.weight.astype(np.float64), (q.src, q.dst)),
        shape=(q.n_clusters, q.n_clusters),
    )
    dist = shortest_path(m, method="D", directed=False)
    finite = np.isfinite(dist)
    diam = float(dist[finite].max()) if finite.any() else 0.0
    return int(diam), bool(finite.all())


def quotient_diameter_minplus(q: QuotientGraph) -> Tuple[int, bool]:
    """Exact diameter by int64 min-plus squaring (a test oracle beside
    scipy's; no float rounding of weights above 2^24). Returns (diameter,
    connected)."""
    k = q.n_clusters
    if k <= 1:
        return 0, True
    m = np.full((k, k), INF64, dtype=np.int64)
    np.minimum.at(m, (q.src, q.dst), q.weight.astype(np.int64))
    np.minimum.at(m, (q.dst, q.src), q.weight.astype(np.int64))
    np.fill_diagonal(m, 0)
    d = torch.from_numpy(m)
    for _ in range(int(np.ceil(np.log2(max(k - 1, 1)))) or 1):
        d = _minplus_square(d)
    arr = d.numpy()
    finite = arr < INF64
    return int(arr[finite].max()), bool(finite.all())


def _minplus_square(d: torch.Tensor) -> torch.Tensor:
    """One guarded int64 min-plus squaring step (INF64 marks unreachable
    pairs; the guard keeps INF64 + INF64 from overflowing)."""
    a = d[:, :, None]
    b = d[None, :, :]
    ok = (a < INF64) & (b < INF64)
    cand = torch.where(ok, torch.where(ok, a, 0) + torch.where(ok, b, 0),
                       INF64)
    return torch.amin(cand, dim=1)

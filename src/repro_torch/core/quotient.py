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

``build_quotient_numpy`` and ``quotient_diameter`` (scipy) are the host
oracles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import next_multiple
from repro_torch.core.chunked import DEFAULT_CHUNK
from repro_torch.core.engine import Decomposition
from repro_torch.core.sssp import INF32, batched_bf_loop
from repro_torch.graph.segment_ops import segment_min_triple
from repro_torch.graph.structures import EdgeList

# Unreached sentinel for the int64 solve; guarded adds stay < 2^63.
INF64 = 2**62
# k is padded to a multiple of this (and m to a multiple of 8x), as the
# reference does for its compile buckets; kept so the padded shapes match.
K_BUCKET = 16


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

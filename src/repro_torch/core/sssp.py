"""Bellman-Ford loops: the SSSP competitor, the farthest-point lower bound
(paper Table 1's Phi column) and the batched all-sources solve that the
quotient pipeline runs — the port of the JAX package's ``core/sssp.py``.

The distance dtype comes from a provable bound (``sssp_dtype_for``): every
shortest path has < n edges, so int32 when ``n * max_weight`` fits, int64
otherwise (torch has native int64; no x64 switch). Unreached is the
dtype's sentinel: 2^31 - 1 for int32, ``INF64 = 2^62`` for int64, so every
guarded add ``d + w`` of an admitted ``d < inf`` stays below 2^63.

Both loops run through ``core/chunked.chunked_while``: one host read per
chunk of supersteps, byte-identical to the reference's ``while_loop``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import resolve_device
from repro_torch.core.chunked import DEFAULT_CHUNK, chunked_while
from repro_torch.graph.segment_ops import segment_min
from repro_torch.graph.structures import EdgeList

INF32 = 2**31 - 1
INF64 = 2**62  # int64 unreached sentinel; guarded adds stay < 2^63


def sssp_dtype_for(n_nodes: int, max_weight: int, delta: int = 0):
    """(dtype, inf) from the provable distance bound ``n * max_weight``
    (plus ``delta`` headroom for bucketed callers)."""
    if n_nodes * max(int(max_weight), 1) + int(delta) < 2**31 - 1:
        return torch.int32, INF32
    return torch.int64, INF64


@dataclass
class SSSPResult:
    dist: np.ndarray
    supersteps: int
    inf: int = INF32   # unreached sentinel of dist's dtype
    syncs: int = 0     # host reads spent


@dataclass
class FarthestPoint:
    """Result of farthest-point hopping."""

    lower: int        # largest realized shortest-path distance
    connected: bool   # every hop reached every node
    first_ecc: int    # eccentricity of the first (random) source
    hops: int         # SSSP runs taken
    supersteps: int   # Bellman-Ford supersteps over all hops
    syncs: int        # host reads over all hops


def _bf_loop(src, dst, w, d0, inf: int, n_nodes: int,
             chunk: int = DEFAULT_CHUNK):
    """Frontier Bellman-Ford in d0's dtype. Returns (d, supersteps, reads).
    The caller's dtype pick makes ``ds + w`` of an admitted ``ds < inf``
    provably fit."""
    idx = src.to(torch.int64)

    def body(carry, more):
        d, changed, k = carry
        ds = d[idx]
        ok = ds < inf
        cand = torch.where(ok, torch.where(ok, ds, 0) + w, inf)
        dmin = segment_min(cand, dst, n_nodes)
        upd = more & (dmin < d)
        return (torch.where(upd, dmin, d), torch.where(more, upd.any(), changed),
                k + more.to(torch.int64))

    dev = d0.device
    init = (d0, torch.ones((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
    (d, _, _), host, reads = chunked_while(
        lambda c: c[1], body, init, chunk=chunk, stats=lambda c: [c[2]],
        reason="bf chunk: packed (more, supersteps)")
    return d, int(host[1]), reads


def batched_bf_loop(src, dst, w, d0, inf: int, n_nodes: int,
                    chunk: int = DEFAULT_CHUNK):
    """Frontier Bellman-Ford over a batch of sources at once.

    ``d0`` is [n_nodes, S], nodes along axis 0: each superstep is one row
    gather ``d[src]`` and one row-wise segment-min. Edges with ``w >= inf``
    never relax (padding). Returns (dist [n_nodes, S], supersteps, reads).
    """
    idx = src.to(torch.int64)
    w_ok = (w < inf)[:, None]
    w_col = w[:, None]

    def body(carry, more):
        d, changed, k = carry
        du = d[idx]                                   # [E, S]
        ok = (du < inf) & w_ok
        cand = torch.where(ok, torch.where(ok, du, 0) + w_col, inf)
        dnew = torch.minimum(d, segment_min(cand, dst, n_nodes))
        dnew = torch.where(more, dnew, d)
        return (dnew, torch.where(more, (dnew < d).any(), changed),
                k + more.to(torch.int64))

    dev = d0.device
    init = (d0, torch.ones((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
    (d, _, _), host, reads = chunked_while(
        lambda c: c[1], body, init, chunk=chunk, stats=lambda c: [c[2]],
        reason="batched bf chunk: packed (more, supersteps)")
    return d, int(host[1]), reads


def _sssp_from(src, dst, w, source: int, n_nodes: int, inf: int,
               chunk: int) -> SSSPResult:
    """Bellman-Ford from ``source`` on device edge arrays whose weights are
    already in the distance dtype; one read of the distance plane."""
    d0 = torch.full((n_nodes,), inf, dtype=w.dtype, device=w.device)
    d0[source] = 0
    d, k, reads = _bf_loop(src, dst, w, d0, inf, n_nodes, chunk)
    dist = guard.fetch(d, reason="sssp: distance plane")
    return SSSPResult(dist=dist, supersteps=k, inf=inf, syncs=reads + 1)


def bellman_ford(edges: EdgeList, source: int, device="cuda",
                 chunk: int = DEFAULT_CHUNK) -> SSSPResult:
    """Single-source Bellman-Ford on ``device`` (uploads the edges once)."""
    dev = resolve_device(device)
    wmax = int(edges.weight.max()) if edges.n_edges else 1
    dtype, inf = sssp_dtype_for(edges.n_nodes, wmax)
    return _sssp_from(
        torch.as_tensor(edges.src).to(dev), torch.as_tensor(edges.dst).to(dev),
        torch.as_tensor(edges.weight).to(device=dev, dtype=dtype),
        source, edges.n_nodes, inf, chunk)


def farthest_point_lower_bound(src, dst, w, n_nodes: int, max_weight: int,
                               rounds: int = 4, seed: int = 0,
                               chunk: int = DEFAULT_CHUNK) -> FarthestPoint:
    """Repeated SSSP hopping to the farthest node on device edge arrays
    (paper Table 1's Phi column). The source draw and the hops match the
    reference's ``farthest_point_lower_bound``; an empty graph gives
    (0, connected)."""
    if n_nodes == 0:
        return FarthestPoint(0, True, 0, 0, 0, 0)
    dtype, inf = sssp_dtype_for(n_nodes, max_weight)
    wd = w.to(dtype)
    rng = np.random.default_rng(seed)
    s = int(rng.integers(n_nodes))
    out = FarthestPoint(0, True, 0, 0, 0, 0)
    for _ in range(rounds):
        res = _sssp_from(src, dst, wd, s, n_nodes, inf, chunk)
        out.hops += 1
        out.supersteps += res.supersteps
        out.syncs += res.syncs
        out.connected = out.connected and bool((res.dist < inf).all())
        dist = np.where(res.dist < inf, res.dist, -1)
        far = int(dist.argmax())
        out.lower = max(out.lower, int(dist.max()))
        if out.hops == 1:
            out.first_ecc = int(dist.max())
        if far == s:
            break
        s = far
    return out

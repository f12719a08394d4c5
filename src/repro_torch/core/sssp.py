"""SSSP loops: the paper's competitor (Bellman-Ford and Meyer & Sanders
Δ-stepping), the farthest-point lower bound (paper Table 1's Phi column),
the 2-approximation from one random source, and the batched all-sources
solve that the quotient pipeline runs — the port of the JAX package's
``core/sssp.py``.

The distance dtype comes from a provable bound (``sssp_dtype_for``): every
shortest path has < n edges, so int32 when ``n * max_weight`` fits, int64
otherwise (torch has native int64; no x64 switch). Unreached is the
dtype's sentinel: 2^31 - 1 for int32, ``INF64 = 2^62`` for int64, so every
guarded add ``d + w`` of an admitted ``d < inf`` stays below 2^63.

Every loop runs through ``core/chunked.chunked_while``: one host read per
chunk of supersteps, byte-identical to the reference's ``while_loop``.
Δ-stepping's two nested loops (the bucket walk and, inside it, the light
edges) become one gated superstep there (``_delta_stepping_loop``), with
the reference's superstep accounting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import resolve_device
from repro_torch.core.chunked import DEFAULT_CHUNK, chunked_while
from repro_torch.graph.segment_ops import segment_min
from repro_torch.graph.structures import EdgeList
from repro_torch.runtime import telemetry

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
class MultiSSSPResult:
    dist: np.ndarray  # [S, n]
    supersteps: int
    connected: bool   # every source reaches every node
    syncs: int = 0    # host reads spent


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


def _delta_stepping_loop(src, dst, w, d0, delta: int, inf: int,
                         n_nodes: int, chunk: int = DEFAULT_CHUNK):
    """Bucketed SSSP in d0's dtype. Returns (d, supersteps, reads). The
    caller must pick the dtype with delta headroom (``sssp_dtype_for(n,
    wmax, delta)``) so the bucket bound ``(b + 1) * delta`` never wraps.

    The reference nests two ``while_loop``s: the bucket walk and, inside
    it, the light-edge loop. Here one gated superstep does one of three
    things, chosen on the device from the carry ``(d, b, k, changed,
    running)``:

      * ``running & changed``: a light relax from bucket ``b`` (one
        superstep; ``changed`` becomes "any distance moved", so the loop's
        last, unchanged pass counts, as in the reference);
      * ``running & ~changed``: the bucket's heavy pass (one superstep only
        when some heavy relaxation is admissible), then the jump to the
        next non-empty bucket (``d_next // delta``, or ``b + 1`` when none
        is ahead), then the outer condition ``any((d < inf) & (d >=
        b * delta)) & (k < 2^30)`` on the new bucket, which sets
        ``running`` and re-arms ``changed``;
      * ``~running``: nothing (``chunked_while``'s no-op).

    Both passes share one gather and one segment-min: the edge class
    (light ``w < delta`` or heavy) is selected on the device.
    """
    dev = d0.device
    idx = src.to(torch.int64)
    light = w < delta
    heavy = ~light
    dl = torch.full((), delta, dtype=d0.dtype, device=dev)
    one = torch.ones((), dtype=d0.dtype, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)

    def outer(d, b, k):
        return ((d < inf) & (d >= b * dl)).any() & (k < 2**30)

    def body(carry, more):
        d, b, k, changed, running = carry
        light_pass = more & changed
        heavy_pass = more & ~changed
        lo, hi = b * dl, (b + one) * dl
        in_bucket = (d >= lo) & (d < hi)
        ds = d[idx]
        ok = (ds < inf) & in_bucket[idx] & torch.where(light_pass, light,
                                                       heavy)
        cand = torch.where(ok, torch.where(ok, ds, 0) + w, inf)
        dmin = segment_min(cand, dst, n_nodes)
        upd = more & (dmin < d)
        d = torch.where(upd, dmin, d)
        k = (k + light_pass.to(torch.int64)
             + (heavy_pass & ok.any()).to(torch.int64))
        # jump straight to the next non-empty bucket
        ahead = (d >= hi) & (d < inf)
        d_next = torch.where(ahead, d, inf).min()
        b = torch.where(heavy_pass, torch.where(
            ahead.any(), torch.div(d_next, dl, rounding_mode="floor"),
            b + one), b)
        running = torch.where(heavy_pass, outer(d, b, k), running)
        changed = torch.where(light_pass, upd.any(),
                              torch.where(heavy_pass, true, changed))
        return d, b, k, changed, running

    b0 = torch.zeros((), dtype=d0.dtype, device=dev)
    k0 = torch.zeros((), dtype=torch.int64, device=dev)
    init = (d0, b0, k0, true, outer(d0, b0, k0))
    (d, _, _, _, _), host, reads = chunked_while(
        lambda c: c[4], body, init, chunk=chunk, stats=lambda c: [c[2]],
        reason="delta-stepping chunk: packed (more, supersteps)")
    return d, int(host[1]), reads


def _sssp_from(src, dst, w, source: int, n_nodes: int, inf: int,
               chunk: int, delta: Optional[int] = None) -> SSSPResult:
    """Bellman-Ford (``delta=None``) or Δ-stepping from ``source`` on
    device edge arrays whose weights are already in the distance dtype;
    one read of the distance plane after the loop's chunk reads."""
    d0 = torch.full((n_nodes,), inf, dtype=w.dtype, device=w.device)
    if n_nodes == 0:  # nothing to relax
        d, k, reads = d0, 0, 0
    else:
        d0.narrow(0, source, 1).fill_(0)
        if delta is None:
            d, k, reads = _bf_loop(src, dst, w, d0, inf, n_nodes, chunk)
        else:
            d, k, reads = _delta_stepping_loop(src, dst, w, d0, delta, inf,
                                               n_nodes, chunk)
    dist = guard.fetch(d, reason="sssp: distance plane")
    return SSSPResult(dist=dist, supersteps=k, inf=inf, syncs=reads + 1)


def _device_edges(edges: EdgeList, device, dtype):
    dev = resolve_device(device)
    return (torch.as_tensor(edges.src).to(dev),
            torch.as_tensor(edges.dst).to(dev),
            torch.as_tensor(edges.weight).to(device=dev, dtype=dtype))


def bellman_ford(edges: EdgeList, source: int, device="cuda",
                 chunk: int = DEFAULT_CHUNK) -> SSSPResult:
    """Single-source Bellman-Ford on ``device`` (uploads the edges once)."""
    wmax = int(edges.weight.max()) if edges.n_edges else 1
    dtype, inf = sssp_dtype_for(edges.n_nodes, wmax)
    return _sssp_from(*_device_edges(edges, device, dtype), source,
                      edges.n_nodes, inf, chunk)


def delta_stepping(edges: EdgeList, source: int, delta: int, device="cuda",
                   chunk: int = DEFAULT_CHUNK) -> SSSPResult:
    """Single-source Δ-stepping (Meyer & Sanders) on ``device``: buckets of
    width ``delta``, light edges (``w < delta``) relaxed to quiescence per
    bucket, then one heavy pass, then a jump to the next non-empty
    bucket."""
    if delta < 1:
        raise ValueError(f"delta must be >= 1, got {delta}")
    wmax = int(edges.weight.max()) if edges.n_edges else 1
    dtype, inf = sssp_dtype_for(edges.n_nodes, wmax, delta)
    return _sssp_from(*_device_edges(edges, device, dtype), source,
                      edges.n_nodes, inf, chunk, delta=delta)


def multi_source_bellman_ford(edges: EdgeList, sources, device="cuda",
                              chunk: int = DEFAULT_CHUNK) -> MultiSSSPResult:
    """All sources at once (``batched_bf_loop``): distances ``[S, n]``, the
    dtype from the same provable bound as the single-source loops."""
    n = edges.n_nodes
    sources = np.asarray(sources, dtype=np.int64)
    wmax = int(edges.weight.max()) if edges.n_edges else 1
    dtype, inf = sssp_dtype_for(n, wmax)
    src, dst, w = _device_edges(edges, device, dtype)
    d0 = torch.full((n, len(sources)), inf, dtype=dtype, device=w.device)
    d0[torch.as_tensor(sources, device=w.device),
       torch.arange(len(sources), device=w.device)] = 0
    d, k, reads = batched_bf_loop(src, dst, w, d0, inf, n, chunk)
    dist = guard.fetch(d, reason="multi-sssp: distance planes").T
    return MultiSSSPResult(dist=dist, supersteps=k,
                           connected=bool((dist < inf).all()),
                           syncs=reads + 1)


def diameter_2approx_sssp(edges: EdgeList, seed: int = 0, device="cuda",
                          chunk: int = DEFAULT_CHUNK
                          ) -> Tuple[int, int, int, bool]:
    """(lower, upper, supersteps, connected) from one Bellman-Ford from a
    random source: ``ecc <= Phi <= 2 ecc``. On a disconnected input the
    bounds cover the source's component only (``connected=False``); an
    empty graph gives (0, 0, 0, True)."""
    if edges.n_nodes == 0:
        return 0, 0, 0, True
    rng = np.random.default_rng(seed)
    s = int(rng.integers(edges.n_nodes))
    res = bellman_ford(edges, s, device=device, chunk=chunk)
    reached = res.dist < res.inf
    ecc = int(res.dist[reached].max())
    return ecc, 2 * ecc, res.supersteps, bool(reached.all())


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
        # each hop is one "sssp.solve" span, as each of the reference
        # estimator's hops is
        with telemetry.span("sssp.solve", source=s) as sp:
            res = _sssp_from(src, dst, wd, s, n_nodes, inf, chunk)
            sp.set(supersteps=res.supersteps)
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

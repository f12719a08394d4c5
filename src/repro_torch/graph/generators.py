"""Seeded synthetic graph families, copied from the JAX package's
``graph/generators.py``: the same numpy calls in the same order, so the
arrays are identical for the same seed.

  * ``road_like`` / ``random_geometric`` — DIMACS road-network family
    (local edges, weights proportional to euclidean distance);
  * ``social_like`` / ``rmat`` — SNAP social family (RMAT power law);
  * ``grid_mesh`` — the paper's square mesh for the Δ experiment.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structures import MAX_WEIGHT, EdgeList


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def assign_weights(
    n_edges: int,
    dist: str = "uniform",
    seed: int = 0,
    low: int = 1,
    high: int = 2**26,
    sigma: float = 2.0,
    mu: float = 1.0,
    heavy_w: int = 10**6,
    heavy_p: float = 0.1,
) -> np.ndarray:
    """Weight distributions: uniform U[low, high], |N(mu, sigma)| >= 1,
    bimodal (heavy_w w.p. heavy_p else 1) and unit."""
    r = _rng(seed)
    if dist == "uniform":
        w = r.integers(low, high + 1, size=n_edges)
    elif dist == "normal":
        w = np.abs(r.normal(0.0, sigma, size=n_edges)) + mu
        w = np.maximum(np.rint(w), 1.0)
    elif dist == "bimodal":
        w = np.where(r.random(n_edges) < heavy_p, heavy_w, 1)
    elif dist == "unit":
        w = np.ones(n_edges)
    else:
        raise ValueError(f"unknown weight dist {dist!r}")
    return np.clip(w, 1, int(MAX_WEIGHT)).astype(np.int32)


def grid_mesh(side: int, weight_dist: str = "unit", seed: int = 0,
              **wkw) -> EdgeList:
    """side x side square mesh."""
    n = side * side
    ids = np.arange(n, dtype=np.int32).reshape(side, side)
    hu, hv = ids[:, :-1].ravel(), ids[:, 1:].ravel()
    vu, vv = ids[:-1, :].ravel(), ids[1:, :].ravel()
    u = np.concatenate([hu, vu])
    v = np.concatenate([hv, vv])
    w = assign_weights(len(u), weight_dist, seed, **wkw)
    return EdgeList.from_undirected(n, u, v, w)


def random_geometric(n: int, avg_degree: float = 3.0, seed: int = 0,
                     weight_scale: int = 10_000) -> EdgeList:
    """Road-network-like graph: random points, each joined to the next k
    points in grid-bucket order, weights proportional to distance."""
    r = _rng(seed)
    pts = r.random((n, 2))
    k = max(2, int(round(avg_degree)))
    cell = int(np.sqrt(n / 4)) + 1
    gx = np.minimum((pts[:, 0] * cell).astype(np.int64), cell - 1)
    gy = np.minimum((pts[:, 1] * cell).astype(np.int64), cell - 1)
    bucket = gx * cell + gy
    order = np.argsort(bucket, kind="stable")
    us, vs = [], []
    for off in range(1, k + 1):
        us.append(order[:-off])
        vs.append(order[off:])
    u = np.concatenate(us).astype(np.int32)
    v = np.concatenate(vs).astype(np.int32)
    d = np.sqrt(((pts[u] - pts[v]) ** 2).sum(axis=1))
    w = np.maximum((d * weight_scale).astype(np.int64), 1).astype(np.int32)
    return EdgeList.from_undirected(n, u, v, w).remove_self_loops().coalesce()


def road_like(n: int, seed: int = 0) -> EdgeList:
    """Road-network defaults (distance weights, ~6 directed edges a node)."""
    return random_geometric(n, avg_degree=3.0, seed=seed)


def rmat(
    n_log2: int,
    n_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weight_dist: str = "uniform",
    **wkw,
) -> EdgeList:
    """RMAT power-law generator (livejournal/orkut family)."""
    r = _rng(seed)
    n = 1 << n_log2
    u = np.zeros(n_edges, dtype=np.int64)
    v = np.zeros(n_edges, dtype=np.int64)
    for _level in range(n_log2):
        p = r.random(n_edges)
        right = p >= a + b
        down_v = ((p >= a) & (p < a + b)) | (p >= a + b + c)
        u = (u << 1) | right.astype(np.int64)
        v = (v << 1) | down_v.astype(np.int64)
    # a random chain through all nodes keeps the graph connected
    perm = r.permutation(n)
    u = np.concatenate([u, perm[:-1]])
    v = np.concatenate([v, perm[1:]])
    w = assign_weights(len(u), weight_dist, seed + 1, **wkw)
    return (
        EdgeList.from_undirected(n, u.astype(np.int32), v.astype(np.int32), w)
        .remove_self_loops()
        .coalesce()
    )


def social_like(n_log2: int = 14, edge_factor: int = 8, seed: int = 0,
                **wkw) -> EdgeList:
    return rmat(n_log2, (1 << n_log2) * edge_factor, seed=seed, **wkw)

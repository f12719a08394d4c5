"""Seeded synthetic graph families, copied from the JAX package's
``graph/generators.py``: the same numpy calls in the same order, so the
arrays are identical for the same seed.

  * ``road_like`` / ``random_geometric`` — DIMACS road-network family
    (local edges, weights proportional to euclidean distance);
  * ``social_like`` / ``rmat`` — SNAP social family (RMAT power law);
  * ``grid_mesh`` — the paper's square mesh for the Δ experiment;
  * ``temporal_trace`` — seeded insert/reweight/delete batches over an
    evolving copy of a graph (dynamic updates).
"""
from __future__ import annotations

from typing import List

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


def temporal_trace(
    edges: EdgeList,
    n_batches: int,
    *,
    events_per_batch: int = 64,
    p_insert: float = 0.4,
    p_reweight: float = 0.4,
    p_delete: float = 0.2,
    insert_mode: str = "local",
    seed: int = 0,
) -> List:
    """Seeded update trace: ``n_batches`` batches of insert/reweight/delete
    events over an evolving copy of ``edges``, simulated on the host so
    every event is valid at its place in the stream (a key is mutated at
    most once a batch) and symmetric (both directions). Weights are drawn
    from the graph's own [min, max] range. ``insert_mode="local"`` joins
    endpoints of two existing edges, ``"random"`` uniform pairs.

    The reference's algorithm draw for draw: its key sets are built from
    Python int pairs in the same order, so ``live`` iterates as the
    reference's does. The reference also maps each key to its least
    weight; nothing reads those values, so ``live`` holds None. Returns a
    list of ``core.dynamic.UpdateBatch``.
    """
    from repro_torch.core.dynamic import UpdateBatch  # graph <- core cycle

    if n_batches < 0:
        raise ValueError(f"n_batches must be >= 0, got {n_batches}")
    if insert_mode not in ("local", "random"):
        raise ValueError(
            f"insert_mode must be local|random, got {insert_mode!r}")
    p_total = p_insert + p_reweight + p_delete
    if p_total <= 0:
        raise ValueError("at least one event probability must be positive")
    n = edges.n_nodes
    if n < 2:
        raise ValueError("temporal_trace needs a graph with >= 2 nodes")
    r = _rng(seed)
    # deletes and reweights are emitted for both directions, so only pairs
    # present in both are eligible
    src, dst = edges.src, edges.dst
    f, b = src < dst, src > dst
    fwd = set(zip(src[f].tolist(), dst[f].tolist()))
    bwd = set(zip(dst[b].tolist(), src[b].tolist()))
    live = dict.fromkeys(fwd & bwd)
    del fwd, bwd
    w_lo = int(edges.weight.min()) if edges.n_edges else 1
    w_hi = int(edges.weight.max()) if edges.n_edges else 1

    def draw_w(k):
        return r.integers(w_lo, w_hi + 1, size=k).astype(np.int64)

    batches: List = []
    for _ in range(n_batches):
        keys = list(live)
        mutated = set()
        ins, rw, dl = [], [], []
        kinds = r.choice(3, size=events_per_batch,
                         p=np.array([p_insert, p_reweight, p_delete]) / p_total)
        for kind in kinds:
            if kind == 0:
                for _try in range(32):
                    if insert_mode == "local" and keys:
                        a = keys[int(r.integers(len(keys)))]
                        b = keys[int(r.integers(len(keys)))]
                        u, v = a[int(r.integers(2))], b[int(r.integers(2))]
                    else:
                        u, v = map(int, r.integers(0, n, 2))
                    u, v = (u, v) if u < v else (v, u)
                    if u != v and (u, v) not in live and (u, v) not in mutated:
                        w = int(draw_w(1)[0])
                        live[(u, v)] = w
                        mutated.add((u, v))
                        ins.append((u, v, w))
                        break
            elif not keys:
                continue
            else:
                for _try in range(32):
                    k = keys[int(r.integers(len(keys)))]
                    if k in mutated or k not in live:
                        continue
                    mutated.add(k)
                    if kind == 1:
                        w = int(draw_w(1)[0])
                        live[k] = w
                        rw.append((*k, w))
                    else:
                        del live[k]
                        dl.append(k)
                    break
        batches.append(UpdateBatch.merge([
            UpdateBatch.inserts([e[0] for e in ins], [e[1] for e in ins],
                                [e[2] for e in ins]),
            UpdateBatch.reweights([e[0] for e in rw], [e[1] for e in rw],
                                  [e[2] for e in rw]),
            UpdateBatch.deletes([e[0] for e in dl], [e[1] for e in dl]),
        ]))
    return batches

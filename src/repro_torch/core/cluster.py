"""CLUSTER(G, tau) and CLUSTER2(G, tau) — paper Algorithms 1 and 2 — as
thin wrappers over the engine (``core/engine.py``) and a backend
(``core/backend.py``); the port of the JAX package's ``core/cluster.py``
(stages and one-shot modes, and CLUSTER2, which is staged only).

The returned radius is the max over nodes of the realized path weight from
the assigned center: an exact upper bound on the clustering radius in G.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.core.backend import RelaxBackend, make_backend
from repro_torch.core.engine import (Decomposition, UniformFn, run_cluster,
                                    run_cluster2, resolve_engine_mode,
                                    run_oneshot)
from repro_torch.graph.structures import EdgeList

__all__ = ["Decomposition", "cluster", "cluster2", "_initial_delta"]


def _initial_delta(edges: EdgeList, mode: str) -> int:
    if edges.n_edges == 0:
        return 1  # nothing to grow along; any positive budget works
    if mode == "min":
        # paper pseudocode: 1 + min edge weight
        return int(edges.weight.min()) + 1
    if mode == "avg":
        # paper Section 5: average edge weight is a good initial guess
        return max(int(edges.weight.mean()), 1)
    return max(int(mode), 1)


def cluster(
    edges: EdgeList,
    tau: int,
    gamma: float = 2.0,
    variant: str = "stop",
    delta_init: str = "avg",
    seed: int = 0,
    max_stages: int = 64,
    max_steps_per_phase: int = 0,
    threshold_const: float = 8.0,
    backend: Union[str, RelaxBackend] = "kernel",
    device="cuda",
    uniform_fn: Optional[UniformFn] = None,
    mode: str = "stages",
    deterministic: bool = False,
) -> Decomposition:
    """Paper Algorithm 1. ``variant`` in {"stop", "complete"}; ``backend``
    is "single", "kernel" or a backend instance (which fixes the device).

    ``mode`` is "stages" (the paper's stage loop), "oneshot" (exponential
    start shifts, one complete grow call) or "auto" (resolves to
    "stages"); unknown names raise before any device work.
    ``deterministic`` applies to oneshot only: hashed centers and shifts.
    """
    mode = resolve_engine_mode(mode)
    be = make_backend(edges, backend, device=device)
    if mode == "oneshot":
        return run_oneshot(
            edges, be, tau, gamma=gamma, seed=seed,
            deterministic=deterministic,
            max_steps_per_phase=max_steps_per_phase, uniform_fn=uniform_fn)
    return run_cluster(
        edges, be, tau,
        gamma=gamma, variant=variant,
        delta0=_initial_delta(edges, delta_init),
        seed=seed, max_stages=max_stages,
        max_steps_per_phase=max_steps_per_phase,
        threshold_const=threshold_const,
        uniform_fn=uniform_fn,
    )


def cluster2(
    edges: EdgeList,
    tau: int,
    gamma: float = 2.0,
    seed: int = 0,
    delta_init: str = "avg",
    base: Optional[Decomposition] = None,
    backend: Union[str, RelaxBackend] = "kernel",
    device="cuda",
    uniform_fn: Optional[UniformFn] = None,
) -> Decomposition:
    """Paper Algorithm 2. Runs CLUSTER (``base``, unless given) for
    R_CL(tau), then re-clusters from scratch with the fixed budget
    Δ = max(2 R_CL(tau), 2), the center probability doubling each stage
    and the last stage taking every node left, each stage grown to
    quiescence (``engine.run_cluster2``, seeded ``seed + 1``).

    ``uniform_fn`` is the base CLUSTER's center draw. When the base run
    happens here, the returned metrics count its host reads and kernel
    launches too: they are part of what the decomposition costs.
    """
    be = make_backend(edges, backend, device=device)
    own_base = base is None
    if own_base:
        base = cluster(edges, tau, gamma=gamma, seed=seed,
                       delta_init=delta_init, backend=be,
                       uniform_fn=uniform_fn)
    delta = max(2 * base.radius, 2)
    dec = run_cluster2(edges, be, tau, delta=delta, seed=seed + 1)
    if own_base:
        m, b = dec.metrics, base.metrics
        m.host_syncs += b.host_syncs + b.finalize_syncs
        m.kernel_launches += b.kernel_launches
        m.kernel_supersteps += b.kernel_supersteps
        m.dma_stall_blocks += b.dma_stall_blocks
    return dec

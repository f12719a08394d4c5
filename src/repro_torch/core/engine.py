"""CLUSTER orchestrator (paper Alg. 1), stages mode — the port of the JAX
package's ``core/engine.py`` (``run_cluster`` and its stage program).

Per stage, on the backend's device-resident planes:

  sample centers -> promote -> reset -> Δ-doubling loop of PartialGrowth
  calls (backend.grow) -> cover

The reference runs a stage as one jitted program with a single host read.
Eager PyTorch cannot loop on a device value without reading it, so here:

  * the stage opens with ONE packed read of (uncovered count, centers
    drawn) — the uncovered count doubles as the previous stage's stop
    decision, and the center probability is computed on the device from
    it (float32, as ``engine.py:406``);
  * every grow call reads one packed stats vector per chunk of supersteps
    (``core/chunked.py``); its last read carries ``reached``, so the
    Δ-doubling decision needs no read of its own;
  * an empty draw is redrawn with one read per redraw (rare: the expected
    draw is γ·τ·log n centers).

The center draw is pluggable: ``uniform_fn(stage, t, n)`` returns the
float32 uniforms of redraw ``t`` of ``stage``. The default seeds a
``torch.Generator`` on the device from ``(seed, stage, t)``; tests inject
the reference's ``jax.random`` uniforms, which makes the decomposition
byte-identical to the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import get_logger
from repro_torch.core.backend import RelaxBackend
from repro_torch.core.state import (
    INF,
    EngineState,
    cover,
    finalize_singletons,
    promote_centers,
    reset_in_stage,
    uncovered_count,
)
from repro_torch.graph.structures import EdgeList

log = get_logger("repro_torch.engine")

MAX_RESAMPLES = 8  # consecutive empty center draws tolerated inside a stage

UniformFn = Callable[[int, int, int], torch.Tensor]


@dataclass
class EngineMetrics:
    """Round/sync accounting."""

    stages: int = 0           # stage-loop iterations (incl. barren draws)
    host_syncs: int = 0       # device->host reads in the stage loop
    grow_calls: int = 0       # PartialGrowth invocations
    state_transfers: int = 0  # plane packs
    resamples: int = 0        # extra center draws taken inside stages
    growing_steps: int = 0    # total supersteps (the MR-round proxy)
    finalize_syncs: int = 0   # reads of the final planes
    kernel_launches: int = 0  # hand-written kernel launches (backend's count)


@dataclass
class Decomposition:
    """Output of CLUSTER."""

    n_nodes: int
    final_c: np.ndarray        # int32 [n] cluster center id per node
    final_pathw: np.ndarray    # int32 [n] dist-from-center upper bound
    radius: int                # R_CL(tau) = max final_pathw
    delta_end: int
    n_clusters: int
    n_stages: int
    growing_steps: int
    metrics: Optional[EngineMetrics] = None
    # device copies of the final planes (length n): the quotient pass
    # consumes these without a host round-trip
    final_c_dev: Optional[torch.Tensor] = None
    final_pathw_dev: Optional[torch.Tensor] = None


def _empty_decomposition(n: int, metrics: EngineMetrics) -> Decomposition:
    return Decomposition(
        n_nodes=n, final_c=np.zeros(n, np.int32),
        final_pathw=np.zeros(n, np.int32), radius=0, delta_end=1,
        n_clusters=n, n_stages=0, growing_steps=0, metrics=metrics,
    )


def default_uniform_fn(seed: int, device) -> UniformFn:
    """Center draws from a ``torch.Generator`` on ``device`` seeded from
    ``(seed, stage, t)`` — deterministic, but not the reference's
    ``jax.random`` stream."""
    dev = torch.device(device)

    def draw(stage: int, t: int, n: int) -> torch.Tensor:
        words = np.random.SeedSequence([seed, stage, t]).generate_state(2)
        g = torch.Generator(device=dev)
        g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
        return torch.rand(n, generator=g, dtype=torch.float32, device=dev)

    return draw


def _sample_centers(uniform_fn: UniformFn, stage: int, t: int, p,
                    state: EngineState, n: int) -> torch.Tensor:
    """Center mask over the n node slots for redraw ``t``."""
    eligible = (~state.covered[:n]) & (~state.is_center[:n])
    u = uniform_fn(stage, t, n).to(device=state.d.device, dtype=torch.float32)
    return (u < p) & eligible


def _cluster_stage(backend: RelaxBackend, state: EngineState, mask,
                   n_new: int, u_host: int, delta: int, max_delta: int,
                   num_it: int, variant: str):
    """One CLUSTER stage after a non-empty draw: promote, reset, Δ-doubling
    PartialGrowth until half the stage's uncovered set is reached, cover.
    Returns (state, delta_end, steps, grow_calls, chunk_reads)."""
    state = promote_centers(state, mask)
    state = reset_in_stage(state)
    # goal: half of the stage's uncovered set, counting the new centers
    half_target = max((u_host + 1) // 2 - n_new, 0)
    dl = delta
    steps = grows = reads = 0
    while True:
        state, gs = backend.grow(state, dl, half_target, num_it, variant)
        steps += gs.steps
        grows += 1
        reads += gs.syncs
        if gs.reached >= half_target or dl >= max_delta:
            break
        dl = min(dl * 2, max_delta)
    return cover(state, dl), dl, steps, grows, reads


def _finalize(state: EngineState, n: int, delta_end: int, n_stages: int,
              total_steps: int, metrics: EngineMetrics) -> Decomposition:
    state = finalize_singletons(state)
    fc_dev = state.final_c[:n]
    fp_dev = state.final_pathw[:n]
    # ONE packed device->host read for both final planes
    planes = guard.fetch(torch.stack([fc_dev, fp_dev]),
                         reason="finalize: packed (final_c, final_pathw)")
    metrics.finalize_syncs += 1
    final_c, final_pathw = planes[0], planes[1]
    if not (final_pathw < INF).all():
        raise AssertionError("uncovered node escaped finalization")
    return Decomposition(
        n_nodes=n,
        final_c=final_c,
        final_pathw=final_pathw,
        radius=int(final_pathw.max()) if n else 0,
        delta_end=delta_end,
        n_clusters=int(len(np.unique(final_c))) if n else 0,
        n_stages=n_stages,
        growing_steps=total_steps,
        metrics=metrics,
        final_c_dev=fc_dev,
        final_pathw_dev=fp_dev,
    )


def run_cluster(
    edges: EdgeList,
    backend: RelaxBackend,
    tau: int,
    *,
    gamma: float = 2.0,
    variant: str = "stop",
    delta0: int = 1,
    seed: int = 0,
    max_stages: int = 64,
    max_steps_per_phase: int = 0,
    threshold_const: float = 8.0,
    max_resamples: int = MAX_RESAMPLES,
    max_delta: Optional[int] = None,
    uniform_fn: Optional[UniformFn] = None,
) -> Decomposition:
    """Paper Algorithm 1 on the backend's device-resident planes."""
    n = edges.n_nodes
    metrics = EngineMetrics()
    if n == 0:
        return _empty_decomposition(0, metrics)
    logn = max(math.log(max(n, 2)), 1.0)
    threshold = max(int(threshold_const * tau * logn), 1)
    num_it = max_steps_per_phase or max(2 * n // max(tau, 1), 8)
    if max_delta is None:
        max_delta = int(edges.weight.astype(np.int64).sum()) + 1
    max_delta = min(max(int(max_delta), 1), 2**30)
    dev = backend.device
    if uniform_fn is None:
        uniform_fn = default_uniform_fn(seed, dev)
    p_scale = torch.tensor(gamma * tau * logn, dtype=torch.float32, device=dev)

    transfers0 = backend.transfers
    launches0 = backend.launches
    state = backend.init_state()
    delta_host = int(delta0)
    u_dev = torch.tensor(n, dtype=torch.int64, device=dev)
    total_steps = n_stages = stage = 0

    while stage < max_stages:
        p = torch.clamp_max(p_scale / u_dev.to(torch.float32), 1.0)
        mask = _sample_centers(uniform_fn, stage, 0, p, state, n)
        # the stage's opening read: the uncovered count (the previous
        # stage's stop decision) and the size of the first draw
        u_host, n_new = map(int, guard.fetch(
            torch.stack([u_dev, mask.sum()]),
            reason="stage open: packed (uncovered, centers drawn)"))
        metrics.host_syncs += 1
        if u_host < threshold:
            break
        resamples = 0
        while n_new == 0 and resamples < max_resamples:
            resamples += 1
            mask = _sample_centers(uniform_fn, stage, resamples, p, state, n)
            n_new = int(guard.fetch(mask.sum(), reason="stage redraw: centers"))
            metrics.host_syncs += 1
        steps = grows = 0
        if n_new > 0:
            state, delta_host, steps, grows, reads = _cluster_stage(
                backend, state, mask, n_new, u_host, delta_host, max_delta,
                num_it, variant)
            metrics.host_syncs += reads
            u_dev = uncovered_count(state)
            n_stages += 1
        metrics.grow_calls += grows
        metrics.resamples += resamples
        total_steps += steps
        stage += 1
        metrics.stages = stage
        log.info("stage %d: centers+%d steps=%d grows=%d resamples=%d "
                 "uncovered_before=%d", stage, n_new, steps, grows,
                 resamples, u_host)

    metrics.growing_steps = total_steps
    metrics.state_transfers = backend.transfers - transfers0
    metrics.kernel_launches = backend.launches - launches0
    return _finalize(state, n, delta_host, n_stages, total_steps, metrics)

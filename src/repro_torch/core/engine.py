"""CLUSTER orchestrator (paper Alg. 1) — the port of the JAX package's
``core/engine.py``: stages mode (``run_cluster``) and one-shot mode
(``run_oneshot``), selected by name (``ENGINE_MODES``).

Stages mode:

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
float32 uniforms of redraw ``t`` of ``stage``. The default reproduces the
reference's ``jax.random`` draws bit for bit (``core/prng.py``), so with
the same seed the decomposition is byte-identical to the reference's;
tests may still inject draws of their own.

One-shot mode (MPVX exponential start times): the full center budget
``k ~ gamma * tau * log n`` is drawn at once, each center enters the wave at
``d = shift_max - shift_c``, and ONE ``complete`` grow call resolves the
race, then ``cover(Δ)``. Its host reads are the grow call's (one per chunk,
or one per fused launch) and the final read of the planes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import get_logger
from repro_torch.core import prng
from repro_torch.core.backend import RelaxBackend
from repro_torch.core.state import (
    INF,
    EngineState,
    cover,
    finalize_singletons,
    promote_centers,
    promote_centers_shifted,
    reset_in_stage,
    uncovered_count,
)
from repro_torch.graph.structures import EdgeList

log = get_logger("repro_torch.engine")

MAX_RESAMPLES = 8  # consecutive empty center draws tolerated inside a stage

UniformFn = Callable[[int, int, int], torch.Tensor]

ENGINE_MODES = ("stages", "oneshot", "auto")


def check_engine_mode(mode: str) -> None:
    """Reject unknown engine modes, naming the valid ones."""
    if mode not in ENGINE_MODES:
        raise ValueError(
            f"unknown engine mode {mode!r} (expected one of {ENGINE_MODES})")


def resolve_engine_mode(mode: str) -> str:
    """Validate ``mode`` and resolve ``"auto"``. The port has no autotuning
    record, so ``"auto"`` resolves to ``"stages"``, as the reference does
    when its record is None."""
    check_engine_mode(mode)
    return "stages" if mode == "auto" else mode


@dataclass
class EngineMetrics:
    """Round/sync accounting."""

    stages: int = 0           # stage-loop iterations (incl. barren draws)
    host_syncs: int = 0       # device->host reads in the stage loop
    grow_calls: int = 0       # PartialGrowth invocations
    state_transfers: int = 0  # plane packs
    resamples: int = 0        # extra center draws taken inside stages
    centers_drawn: int = 0    # centers of all stages' draws
    uncovered_at_stop: int = 0  # nodes left when the stop rule fired; each
                                # becomes a singleton cluster
    growing_steps: int = 0    # total supersteps (the MR-round proxy)
    finalize_syncs: int = 0   # reads of the final planes
    kernel_launches: int = 0  # hand-written kernel launches (backend's count)
    kernel_supersteps: int = 0  # supersteps run inside fused calls
    dma_stall_blocks: int = 0   # rows the fused calls skipped (frontier or
                                # frozen); the reference counted edge blocks


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
    """The reference's stage center draw, bit for bit: redraw ``t`` of
    ``stage`` is ``uniform(fold_in(fold_in(PRNGKey(seed), stage), t), n)``
    (``jax.random``, reproduced on ``device`` by ``core/prng.py``)."""
    root = prng.prng_key(seed)

    def draw(stage: int, t: int, n: int) -> torch.Tensor:
        return prng.uniform(prng.fold_in(prng.fold_in(root, stage), t), n,
                            device)

    return draw


def default_oneshot_uniform_fn(seed: int, device) -> UniformFn:
    """The reference's random one-shot draw, bit for bit: ``u1`` (``t = 0``)
    and ``u2`` (``t = 1``) are uniforms of the two halves of
    ``split(PRNGKey(seed))``."""
    keys = prng.split(prng.prng_key(seed))

    def draw(stage: int, t: int, n: int) -> torch.Tensor:
        return prng.uniform(keys[t], n, device)

    return draw


def _sample_centers(uniform_fn: UniformFn, stage: int, t: int, p,
                    state: EngineState, n: int) -> torch.Tensor:
    """Center mask over the n node slots for redraw ``t``."""
    eligible = (~state.covered[:n]) & (~state.is_center[:n])
    u = uniform_fn(stage, t, n).to(device=state.d.device, dtype=torch.float32)
    return (u < p) & eligible


def _grow(backend: RelaxBackend, state: EngineState, delta: int,
          half_target: int, num_it: int, variant: str,
          metrics: EngineMetrics):
    """One PartialGrowth call; adds its host reads and fused-call counters
    to ``metrics``."""
    state, gs = backend.grow(state, delta, half_target, num_it, variant)
    metrics.host_syncs += gs.syncs
    metrics.grow_calls += 1
    metrics.kernel_supersteps += gs.kernel_supersteps
    metrics.dma_stall_blocks += gs.dead_blocks
    return state, gs


def _cluster_stage(backend: RelaxBackend, state: EngineState, mask,
                   n_new: int, u_host: int, delta: int, max_delta: int,
                   num_it: int, variant: str, metrics: EngineMetrics):
    """One CLUSTER stage after a non-empty draw: promote, reset, Δ-doubling
    PartialGrowth until half the stage's uncovered set is reached, cover.
    Returns (state, delta_end, steps, grow_calls)."""
    state = promote_centers(state, mask)
    state = reset_in_stage(state)
    # goal: half of the stage's uncovered set, counting the new centers
    half_target = max((u_host + 1) // 2 - n_new, 0)
    dl = delta
    steps = grows = 0
    while True:
        state, gs = _grow(backend, state, dl, half_target, num_it, variant,
                          metrics)
        steps += gs.steps
        grows += 1
        if gs.reached >= half_target or dl >= max_delta:
            break
        dl = min(dl * 2, max_delta)
    return cover(state, dl), dl, steps, grows


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
            metrics.uncovered_at_stop = u_host
            break
        resamples = 0
        while n_new == 0 and resamples < max_resamples:
            resamples += 1
            mask = _sample_centers(uniform_fn, stage, resamples, p, state, n)
            n_new = int(guard.fetch(mask.sum(), reason="stage redraw: centers"))
            metrics.host_syncs += 1
        steps = grows = 0
        metrics.centers_drawn += n_new
        if n_new > 0:
            state, delta_host, steps, grows = _cluster_stage(
                backend, state, mask, n_new, u_host, delta_host, max_delta,
                num_it, variant, metrics)
            u_dev = uncovered_count(state)
            n_stages += 1
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


# ---------------------------------------------------------------------------
# one-shot mode
# ---------------------------------------------------------------------------


def hashed_uniforms(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic draw: Knuth multiplicative hashes of the node id as
    float32 ``(u1, u2)`` (``u2`` never 0). The uint32 product is taken in
    int64 and masked to 32 bits, then converted to float32, which rounds
    exactly as the reference's uint32 -> float32 conversion."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    h1 = (ids * 2654435761) & 0xFFFFFFFF
    h2 = (ids * 2246822519) & 0xFFFFFFFF
    u1 = h1.to(torch.float32) * (2.0 ** -32)
    u2 = (h2.to(torch.float32) + 0.5) * (2.0 ** -32)
    return u1, u2


def oneshot_centers(u1: torch.Tensor, u2: torch.Tensor, p: float,
                    shift_max: int,
                    shift_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Center mask and start planes from the uniforms.

    ``u1 < p`` draws the centers; an empty draw takes the argmin-``u1`` node
    (the first on ties), so the decomposition never degenerates to all
    singletons. Each node's shift ``-log(u2) * shift_scale``, clamped to
    ``[0, shift_max]`` before and after the float32 -> int32 cast, gives
    ``start_d = shift_max - shift_i``. XLA's and torch's float32 ``log``
    may differ in the last ulp, which can move ``shift_i`` by one.
    """
    dev = u1.device
    ids = torch.arange(u1.shape[0], dtype=torch.int64, device=dev)
    mask = u1 < torch.tensor(p, dtype=torch.float32, device=dev)
    mask = torch.where(mask.any(), mask, ids == torch.argmin(u1))
    f32 = dict(dtype=torch.float32, device=dev)
    shift = torch.minimum(-torch.log(u2) * torch.tensor(shift_scale, **f32),
                          torch.tensor(float(shift_max), **f32))
    shift_i = torch.clamp(shift.to(torch.int32), 0, shift_max)
    return mask, (shift_max - shift_i).to(torch.int32)


class OneshotBudget(NamedTuple):
    p: float            # center probability (compared in float32)
    num_it: int         # superstep cap of the one grow call
    max_delta: int      # the fixed Δ
    shift_max: int      # shifts lie in [0, shift_max]
    shift_scale: float  # a float32 value


def oneshot_budget(edges: EdgeList, tau: int, gamma: float = 2.0,
                   max_steps_per_phase: int = 0,
                   max_delta: Optional[int] = None) -> OneshotBudget:
    """The one-shot scalars of the reference's ``run_oneshot``: center
    probability ``gamma * tau * log n / n``, ``num_it = 4n``, Δ, and the
    shift range and scale."""
    n = edges.n_nodes
    logn = max(math.log(max(n, 2)), 1.0)
    k_target = max(gamma * tau * logn, 1.0)
    if max_delta is None:
        # a few times the per-center weight share, floored at 4x the average
        # edge weight: radius is bounded by Δ, so the full weight sum would
        # be a hopelessly loose fixed budget
        wsum = int(edges.weight.astype(np.int64).sum())
        avg_w = wsum // max(edges.n_edges, 1)
        max_delta = int(max(4.0 * wsum / k_target, 4.0 * avg_w)) + 1
    max_delta = min(max(int(max_delta), 1), 2**30)
    # shifts live in the lower half of the Δ budget
    return OneshotBudget(
        p=min(1.0, k_target / n),
        num_it=max_steps_per_phase or 4 * n,
        max_delta=max_delta,
        shift_max=max_delta // 2,
        shift_scale=float(np.float32(
            (max_delta // 2) / max(math.log(max(k_target, 2.0)), 1.0))))


def run_oneshot(
    edges: EdgeList,
    backend: RelaxBackend,
    tau: int,
    *,
    gamma: float = 2.0,
    seed: int = 0,
    deterministic: bool = False,
    max_steps_per_phase: int = 0,
    max_delta: Optional[int] = None,
    uniform_fn: Optional[UniformFn] = None,
    start_d: Optional[torch.Tensor] = None,
) -> Decomposition:
    """One-shot exponential-shift decomposition (MPVX exponential start
    times; with ``deterministic=True`` the centers and shifts are hashes of
    the node id, so the result is a seed-independent function of the
    graph).

    The random draw takes ``u1 = uniform_fn(0, 0, n)`` and ``u2 =
    uniform_fn(0, 1, n)`` (default: ``default_oneshot_uniform_fn(seed)``,
    the reference's ``jax.random.split`` uniforms bit for bit). ``start_d``
    replaces the computed start planes (tests pass the reference's, which
    takes the float32 ``log`` out of the comparison).

    ``pathw`` accumulates the realized path weight from the owning center
    (centers start at 0), so ``final_pathw`` stays a distance certificate;
    nodes no shifted wave reaches within Δ become singletons.
    """
    n = edges.n_nodes
    metrics = EngineMetrics()
    if n == 0:
        return _empty_decomposition(0, metrics)
    p, num_it, max_delta, shift_max, shift_scale = oneshot_budget(
        edges, tau, gamma, max_steps_per_phase, max_delta)
    dev = backend.device
    transfers0 = backend.transfers
    launches0 = backend.launches
    state = backend.init_state()
    if deterministic:
        u1, u2 = hashed_uniforms(n, dev)
    else:
        draw = uniform_fn or default_oneshot_uniform_fn(seed, dev)
        u1 = draw(0, 0, n).to(device=dev, dtype=torch.float32)
        u2 = torch.clamp_min(draw(0, 1, n).to(device=dev, dtype=torch.float32),
                             2.0 ** -32)
    mask, start = oneshot_centers(u1, u2, p, shift_max, shift_scale)
    if start_d is not None:
        start = torch.as_tensor(start_d, dtype=torch.int32).to(dev)
    state = promote_centers_shifted(state, mask, start)
    # no in-stage reset: every non-center is already unreached, and a reset
    # would zero the shifts
    state, gs = _grow(backend, state, max_delta, 0, num_it, "complete",
                      metrics)
    state = cover(state, max_delta)
    metrics.stages = 1
    metrics.growing_steps = gs.steps
    metrics.state_transfers = backend.transfers - transfers0
    metrics.kernel_launches = backend.launches - launches0
    log.info("oneshot: steps=%d grow reads=%d deterministic=%s", gs.steps,
             gs.syncs, deterministic)
    return _finalize(state, n, max_delta, 1, gs.steps, metrics)


class DecompositionMode(NamedTuple):
    """A decomposition strategy: its name and its runner over a built
    ``RelaxBackend``."""

    name: str
    runner: Callable[..., Decomposition]


DECOMPOSITION_MODES: Dict[str, DecompositionMode] = {
    "stages": DecompositionMode("stages", run_cluster),
    "oneshot": DecompositionMode("oneshot", run_oneshot),
}

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
    it (float32, as ``engine.py:406``). The read is made at the end of
    the previous stage, inside its ``engine.stage`` span, so the stop
    decision lies in the stage that made it, as in the reference; the
    first stage's uncovered count is ``n`` (or the checkpoint's), known on
    the host, so its opening read is the draw's size alone, and a graph
    below the stop threshold reads nothing before its final planes;
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

A ``StageCheckpointer`` makes the stages mode preemption-safe: at every
stage boundary it saves the planes, the root key and the stage scalars
(``checkpoint/checkpoint.py``), and a resumed run restores them and
finishes byte-identically. One-shot mode has no stage boundary and takes
no checkpointer.
"""
from __future__ import annotations

import math
import os
import re
import shutil
import signal as _signal
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.common import Timer, get_logger, to_device
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
from repro_torch.runtime.fault import Preempted, PreemptionGuard
from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import clock

log = get_logger("repro_torch.engine")

MAX_RESAMPLES = 8  # consecutive empty center draws tolerated inside a stage

UniformFn = Callable[[int, int, int], torch.Tensor]

ENGINE_MODES = ("stages", "oneshot", "auto")


def check_engine_mode(mode: str) -> None:
    """Reject unknown engine modes, naming the valid ones."""
    if mode not in ENGINE_MODES:
        raise ValueError(
            f"unknown engine mode {mode!r} (expected one of {ENGINE_MODES})")


def resolve_engine_mode(mode: str, tuning=None) -> str:
    """Validate ``mode`` and resolve ``"auto"``: the autotuning record's
    choice (``core/autotune.TuningRecord.mode``) when there is one, else
    ``"stages"``."""
    check_engine_mode(mode)
    if mode == "auto":
        return tuning.mode if tuning is not None else "stages"
    return mode


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
    # reads spent by stage-boundary checkpoint saves (the planes and the
    # boundary's uncovered count) and by a resume's restore (the kernel
    # backend's long-row count when a store is restored). Outside
    # host_syncs: the save cadence is a durability knob, not a round of
    # the algorithm. Every read of a query is host_syncs + finalize_syncs
    # + checkpoint_syncs.
    checkpoint_syncs: int = 0


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
    return uniform_fn_from_key(prng.prng_key(seed), device)


def uniform_fn_from_key(root: prng.Key, device) -> UniformFn:
    """The stage center draw from a root key's two words (a checkpoint's
    ``key`` leaf): ``uniform(fold_in(fold_in(root, stage), t), n)``."""
    root = (int(root[0]), int(root[1]))

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


# ---------------------------------------------------------------------------
# stage-boundary checkpoints
# ---------------------------------------------------------------------------


@dataclass
class StageCheckpointer:
    """Stage-boundary checkpoint and restore for the stages mode.

    At every stage boundary ``run_cluster`` hands this hook the
    ``EngineState`` planes, the root key (the two uint32 words of
    ``PRNGKey(seed)``), the stage scalars (``stage``, ``delta``,
    ``uncovered``, ``total_steps``, ``n_stages``, ``seed``, ``n``, ``tau``,
    ``variant``) and, with a ``store`` attached, its host buffers. Every
    ``every``-th stage the tree goes through ``checkpoint.save`` (an atomic
    rename, so a writer killed midway never corrupts the latest step).

    The boundary hands the hook the uncovered count as a device scalar: a
    save reads it (and the planes) inside its own ``guard.metered()``
    region and books those reads as ``EngineMetrics.checkpoint_syncs``; a
    boundary without a save reads nothing.

    Under an entered :class:`PreemptionGuard` whose signal fired, the save
    is unconditional and :class:`Preempted` is raised AFTER it is durable.
    A resume is byte-identical: the draws of stage ``s`` redraw ``t`` are
    ``fold_in(fold_in(key, s), t)``, the state is all int32/bool, and the
    saved key and stage counter regenerate exactly the remaining draws.

    ``preempt_after_stage = k`` sends a REAL ``SIGTERM`` to this process
    at boundary k (a test hook), so it needs an attached, entered guard.
    """

    ckpt_dir: str
    guard: Optional[PreemptionGuard] = None
    store: Optional[Any] = None      # graph.storage.EdgeStore / GraphStore
    every: int = 1
    keep: int = 3
    resume: bool = False
    preempt_after_stage: int = 0     # 0 = never; k = SIGTERM at boundary k
    saves: int = 0
    restores: int = 0
    last_path: Optional[str] = None
    # host clock of each stage (its opening read to its boundary) and of
    # each save, and each saved step's bytes on disk
    stage_seconds: List[float] = field(default_factory=list)
    save_seconds: List[float] = field(default_factory=list)
    save_bytes: List[int] = field(default_factory=list)
    _fired: bool = field(default=False, repr=False)

    def _tree(self, state, key) -> Dict[str, Any]:
        tree: Dict[str, Any] = {"planes": state, "key": key}
        if self.store is not None:
            tree["store"] = self.store.state_dict()
        return tree

    def save(self, state, key, scalars: Dict[str, Any],
             metrics: Optional[EngineMetrics] = None) -> str:
        """Write one step; 0-d tensor scalars are read here, in one packed
        read, inside the save's meter."""
        with Timer() as t, guard.metered() as m:
            lazy = [k for k, v in scalars.items()
                    if isinstance(v, torch.Tensor)]
            if lazy:
                vals = guard.fetch(
                    torch.stack([scalars[k].to(torch.int64) for k in lazy]),
                    reason="checkpoint save: packed boundary scalars")
                scalars = {**scalars, **dict(zip(lazy, vals.tolist()))}
            extra: Dict[str, Any] = {"engine": {
                k: int(v) if isinstance(v, (int, np.integer)) else v
                for k, v in scalars.items()}}
            if self.store is not None:
                extra["store"] = self.store.extra_state()
            path = ckpt.save(self.ckpt_dir, int(scalars["stage"]),
                             self._tree(state, key), extra=extra,
                             keep=self.keep)
        if metrics is not None:
            metrics.checkpoint_syncs += m.transfers
        self.saves += 1
        self.last_path = path
        self.save_seconds.append(t.seconds)
        self.save_bytes.append(sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)))
        return path

    def at_stage_boundary(self, state, key, scalars: Dict[str, Any],
                          metrics: Optional[EngineMetrics] = None,
                          stage_seconds: Optional[float] = None) -> None:
        """Called by ``run_cluster`` after each stage (``stage_seconds``:
        its host clock). Saves on cadence; on an observed preemption saves
        unconditionally and raises :class:`Preempted`."""
        if stage_seconds is not None:
            self.stage_seconds.append(stage_seconds)
        stage = int(scalars["stage"])
        if (self.preempt_after_stage and stage >= self.preempt_after_stage
                and not self._fired):
            if self.guard is None:
                raise RuntimeError(
                    "preempt_after_stage requires an attached (and entered) "
                    "PreemptionGuard: a raw SIGTERM would kill the process")
            self._fired = True
            # a REAL signal: the guard's handler runs on delivery, before
            # the check below
            os.kill(os.getpid(), _signal.SIGTERM)
        preempted = self.guard is not None and self.guard.should_stop
        if preempted or (self.every and stage % self.every == 0):
            self.save(state, key, scalars, metrics)
        if preempted:
            raise Preempted(stage, self.last_path,
                            getattr(self.guard, "received", None))

    def try_restore(self, like_state, like_key, backend=None):
        """``(state, key, scalars)`` from the latest step, or None when the
        directory holds none (a fresh start). The planes land on
        ``like_state``'s device with its dtypes; an attached store is
        restored in place, which uploads its edges anew, so ``backend``
        (the one the run grows on) is rebound to the store's new arrays
        and the old ones are freed."""
        if ckpt.latest_step(self.ckpt_dir) is None:
            return None
        tree, extra = ckpt.restore(self.ckpt_dir,
                                   self._tree(like_state, like_key))
        if self.store is not None and "store" in tree:
            self.store.load_state(tree["store"], extra.get("store", {}))
            if backend is not None:
                backend.rebind(self.store.src, self.store.dst,
                               self.store.weight)
        self.restores += 1
        return tree["planes"], tree["key"], extra.get("engine", {})

    def complete(self) -> None:
        """The decomposition finished: remove the step directories (a later
        query on the directory must not resume a finished run) and consume
        the resume flag."""
        self.resume = False
        if os.path.isdir(self.ckpt_dir):
            for d in os.listdir(self.ckpt_dir):
                if re.fullmatch(r"step_\d+", d):
                    shutil.rmtree(os.path.join(self.ckpt_dir, d),
                                  ignore_errors=True)


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
    with telemetry.span("engine.finalize", n=n) as sp:
        # ONE packed device->host read for both final planes
        planes = guard.fetch(torch.stack([fc_dev, fp_dev]),
                             reason="finalize: packed (final_c, final_pathw)")
        metrics.finalize_syncs += 1
        sp.set(supersteps=total_steps,
               checkpoint_syncs=metrics.checkpoint_syncs)
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
    edges: Optional[EdgeList],
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
    checkpointer: Optional[StageCheckpointer] = None,
) -> Decomposition:
    """Paper Algorithm 1 on the backend's device-resident planes.

    ``edges`` may be None when the graph exists only as the backend's
    device arrays (a cascade level): ``max_delta`` (the Δ-doubling ceiling,
    otherwise the host weight sum + 1) must then be given, and the node
    count comes from ``backend.n_nodes``.

    ``checkpointer`` saves the state at stage boundaries; an observed
    SIGTERM/SIGINT raises ``Preempted`` after a durable save, and with
    ``checkpointer.resume`` the latest step is restored (a divergent seed,
    n, tau or variant is refused) and the run finishes byte-identically.
    On resume the draws come from the restored key unless ``uniform_fn``
    was given."""
    if edges is None and max_delta is None:
        raise ValueError("run_cluster(edges=None) needs an explicit max_delta")
    n = backend.n_nodes if edges is None else edges.n_nodes
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
    injected = uniform_fn is not None
    if uniform_fn is None:
        uniform_fn = default_uniform_fn(seed, dev)
    p_scale = torch.full((), gamma * tau * logn, dtype=torch.float32,
                         device=dev)

    transfers0 = backend.transfers
    launches0 = backend.launches
    state = backend.init_state()
    # the reference's PRNGKey(seed): the root every stage's draw folds from
    key = np.asarray(prng.prng_key(seed), np.uint32)
    delta_host = int(delta0)
    u_dev = torch.full((), n, dtype=torch.int64, device=dev)
    u_host = n
    total_steps = n_stages = stage = 0

    if checkpointer is not None and checkpointer.resume:
        # a store's restore rebinds the backend, which reads the kernel
        # backend's long-row count once: a checkpoint read, not a round
        with guard.metered() as restore_reads:
            restored = checkpointer.try_restore(state, key, backend)
        metrics.checkpoint_syncs += restore_reads.transfers
        checkpointer.resume = False   # consumed either way
        if restored is not None:
            state, key, sc = restored
            for want, got in (("seed", seed), ("n", n), ("tau", tau),
                              ("variant", variant)):
                if want in sc and sc[want] != got:
                    raise ValueError(
                        f"checkpoint {want}={sc[want]!r} does not match this "
                        f"run's {want}={got!r}; refusing a divergent resume")
            stage = int(sc["stage"])
            delta_host = int(sc["delta"])
            u_host = int(sc["uncovered"])
            u_dev = torch.full((), u_host, dtype=torch.int64, device=dev)
            total_steps = int(sc["total_steps"])
            n_stages = int(sc["n_stages"])
            metrics.stages = stage
            if not injected:
                uniform_fn = uniform_fn_from_key(key, dev)
            log.info("resumed decomposition at stage %d (uncovered=%d, "
                     "delta=%d) from %s", stage, int(sc["uncovered"]),
                     delta_host, checkpointer.ckpt_dir)

    def open_stage(stage: int):
        """The stage's center probability, computed on the device from the
        uncovered count (float32, as ``engine.py:406``), and its first
        draw."""
        p = torch.clamp_max(p_scale / u_dev.to(torch.float32), 1.0)
        return p, _sample_centers(uniform_fn, stage, 0, p, state, n)

    mask = None   # the stage's first draw, once its size has been read
    n_new = 0
    while stage < max_stages and u_host >= threshold:
        t_stage = clock()
        with telemetry.span("engine.stage", stage=stage) as sp:
            launches_stage = backend.launches
            stall_stage = metrics.dma_stall_blocks
            if mask is None:
                # the first stage's opening read (its uncovered count is
                # known on the host): the size of its draw
                p, mask = open_stage(stage)
                n_new = int(guard.fetch(mask.sum(),
                                        reason="stage open: centers drawn"))
                metrics.host_syncs += 1
            resamples = 0
            while n_new == 0 and resamples < max_resamples:
                resamples += 1
                mask = _sample_centers(uniform_fn, stage, resamples, p, state,
                                       n)
                n_new = int(guard.fetch(mask.sum(),
                                        reason="stage redraw: centers"))
                metrics.host_syncs += 1
            steps = grows = 0
            metrics.centers_drawn += n_new
            if n_new > 0:
                state, delta_host, steps, grows = _cluster_stage(
                    backend, state, mask, n_new, u_host, delta_host,
                    max_delta, num_it, variant, metrics)
                u_dev = uncovered_count(state)
                n_stages += 1
            metrics.resamples += resamples
            total_steps += steps
            centers, u_before = n_new, u_host
            stage += 1
            metrics.stages = stage
            sp.set(centers=centers, supersteps=steps, grow_calls=grows,
                   kernel_launches=backend.launches - launches_stage,
                   dma_stall_blocks=metrics.dma_stall_blocks - stall_stage)
            mask = None
            if stage < max_stages:
                # the next stage's opening read, inside this stage's span:
                # the uncovered count is this stage's stop decision, packed
                # with the size of the next stage's first draw
                p, mask = open_stage(stage)
                u_host, n_new = map(int, guard.fetch(
                    torch.stack([u_dev, mask.sum()]),
                    reason="stage open: packed (uncovered, centers drawn)"))
                metrics.host_syncs += 1
                sp.set(uncovered=u_host)
        log.info("stage %d: centers+%d steps=%d grows=%d resamples=%d "
                 "uncovered_before=%d", stage, centers, steps, grows,
                 resamples, u_before)
        if checkpointer is not None:
            # the boundary hands a save the device count, which it reads
            checkpointer.at_stage_boundary(
                state, key,
                {"stage": stage, "delta": delta_host, "uncovered": u_dev,
                 "total_steps": total_steps, "n_stages": n_stages,
                 "seed": seed, "n": n, "tau": tau, "variant": variant},
                metrics, stage_seconds=clock() - t_stage)
    if u_host < threshold:
        metrics.uncovered_at_stop = u_host

    if checkpointer is not None:
        checkpointer.complete()
    metrics.growing_steps = total_steps
    metrics.state_transfers = backend.transfers - transfers0
    metrics.kernel_launches = backend.launches - launches0
    return _finalize(state, n, delta_host, n_stages, total_steps, metrics)


# ---------------------------------------------------------------------------
# CLUSTER2 (paper Algorithm 2)
# ---------------------------------------------------------------------------


def default_cluster2_uniform_fn(seed: int, device) -> UniformFn:
    """The reference's CLUSTER2 draw, bit for bit: stage ``i`` draws
    ``uniform(fold_in(PRNGKey(seed), i), n)`` (one ``fold_in``, not the
    stage engine's ``(stage, t)`` pair; CLUSTER2 never redraws, so ``t``
    is unused)."""
    root = prng.prng_key(seed)

    def draw(stage: int, t: int, n: int) -> torch.Tensor:
        return prng.uniform(prng.fold_in(root, stage), n, device)

    return draw


def run_cluster2(
    edges: EdgeList,
    backend: RelaxBackend,
    tau: int,
    *,
    delta: int,
    seed: int = 0,
) -> Decomposition:
    """Paper Algorithm 2's re-clustering pass with the fixed budget
    ``delta`` (= 2 R_CL(tau), see ``cluster.cluster2``).

    Stage ``i = 1 .. ceil(log2 n) + 1`` draws centers among the uncovered
    nodes with ``p = min(1, 2^i / n)`` (computed in Python floats and
    compared as float32; the last stage takes p = 1), grows them with the
    ``complete`` variant to quiescence (``num_it = 4n``) and covers what
    lies within ``delta``. Each stage opens with ONE packed read of
    (uncovered, centers drawn), made at the end of the stage before it
    inside its span (the first stage reads its draw's size alone): the
    loop ends when nothing is uncovered, and a barren stage runs no
    grow.
    """
    n = edges.n_nodes
    metrics = EngineMetrics()
    if n == 0:
        return _empty_decomposition(0, metrics)
    num_it = 4 * n
    dev = backend.device
    uniform_fn = default_cluster2_uniform_fn(seed, dev)
    transfers0 = backend.transfers
    launches0 = backend.launches
    state = backend.init_state()
    stages = int(math.ceil(math.log2(max(n, 2)))) + 1
    total_steps = stage_count = 0
    u_dev = torch.full((), n, dtype=torch.int64, device=dev)
    u_host = n

    def draw(i: int) -> torch.Tensor:
        p = 1.0 if i == stages else min(1.0, (2.0 ** i) / n)
        return _sample_centers(uniform_fn, i, 0,
                               torch.full((), p, dtype=torch.float32,
                                          device=dev), state, n)

    mask = None   # the stage's draw, once its size has been read
    n_new = 0
    for i in range(1, stages + 1):
        if u_host == 0:
            break
        with telemetry.span("engine.stage", stage=i,
                            variant="cluster2") as sp:
            launches_stage = backend.launches
            stall_stage = metrics.dma_stall_blocks
            if mask is None:
                # the first stage's opening read (every node is uncovered):
                # the size of its draw
                mask = draw(i)
                n_new = int(guard.fetch(
                    mask.sum(), reason="cluster2 stage open: centers drawn"))
                metrics.host_syncs += 1
            steps = 0
            if n_new > 0:
                state = reset_in_stage(promote_centers(state, mask))
                state, gs = _grow(backend, state, delta, 0, num_it,
                                  "complete", metrics)
                state = cover(state, delta)
                u_dev = uncovered_count(state)
                steps = gs.steps
                stage_count += 1
            metrics.stages += 1
            metrics.centers_drawn += n_new
            total_steps += steps
            centers, u_before = n_new, u_host
            sp.set(centers=centers, supersteps=steps,
                   kernel_launches=backend.launches - launches_stage,
                   dma_stall_blocks=metrics.dma_stall_blocks - stall_stage)
            mask = None
            if i < stages:
                # the next stage's opening read, inside this stage's span:
                # the uncovered count (this stage's stop decision) and the
                # size of the next draw
                mask = draw(i + 1)
                u_host, n_new = map(int, guard.fetch(
                    torch.stack([u_dev, mask.sum()]),
                    reason="cluster2 stage open: packed (uncovered, "
                           "centers drawn)"))
                metrics.host_syncs += 1
                sp.set(uncovered=u_host)
        log.info("cluster2 stage %d: centers+%d steps=%d "
                 "uncovered_before=%d", i, centers, steps, u_before)

    metrics.growing_steps = total_steps
    metrics.state_transfers = backend.transfers - transfers0
    metrics.kernel_launches = backend.launches - launches0
    return _finalize(state, n, int(delta), stage_count, total_steps, metrics)


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
    mask = u1 < torch.full((), p, dtype=torch.float32, device=dev)
    mask = torch.where(mask.any(), mask, ids == torch.argmin(u1))
    f32 = dict(dtype=torch.float32, device=dev)
    shift = torch.minimum(-torch.log(u2) * torch.full((), shift_scale, **f32),
                          torch.full((), float(shift_max), **f32))
    shift_i = torch.clamp(shift.to(torch.int32), 0, shift_max)
    return mask, (shift_max - shift_i).to(torch.int32)


class OneshotBudget(NamedTuple):
    p: float            # center probability (compared in float32)
    num_it: int         # superstep cap of the one grow call
    max_delta: int      # the fixed Δ
    shift_max: int      # shifts lie in [0, shift_max]
    shift_scale: float  # a float32 value


def oneshot_budget(edges: Optional[EdgeList], tau: int, gamma: float = 2.0,
                   max_steps_per_phase: int = 0,
                   max_delta: Optional[int] = None, *,
                   n_nodes: Optional[int] = None) -> OneshotBudget:
    """The one-shot scalars of the reference's ``run_oneshot``: center
    probability ``gamma * tau * log n / n``, ``num_it = 4n``, Δ, and the
    shift range and scale. With ``edges=None`` (a cascade level) the node
    count is ``n_nodes`` and ``max_delta`` must be given."""
    n = edges.n_nodes if edges is not None else n_nodes
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
    edges: Optional[EdgeList],
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

    As in ``run_cluster``, ``edges`` may be None for a graph resident only
    as the backend's device arrays; ``max_delta`` must then be given.
    """
    if edges is None and max_delta is None:
        raise ValueError("run_oneshot(edges=None) needs an explicit max_delta")
    n = backend.n_nodes if edges is None else edges.n_nodes
    metrics = EngineMetrics()
    if n == 0:
        return _empty_decomposition(0, metrics)
    p, num_it, max_delta, shift_max, shift_scale = oneshot_budget(
        edges, tau, gamma, max_steps_per_phase, max_delta, n_nodes=n)
    dev = backend.device
    transfers0 = backend.transfers
    launches0 = backend.launches
    state = backend.init_state()
    with telemetry.span("engine.oneshot", n=n,
                        deterministic=deterministic) as sp:
        if deterministic:
            u1, u2 = hashed_uniforms(n, dev)
        else:
            draw = uniform_fn or default_oneshot_uniform_fn(seed, dev)
            u1 = draw(0, 0, n).to(device=dev, dtype=torch.float32)
            u2 = torch.clamp_min(
                draw(0, 1, n).to(device=dev, dtype=torch.float32), 2.0 ** -32)
        mask, start = oneshot_centers(u1, u2, p, shift_max, shift_scale)
        if start_d is not None:
            start = to_device(start_d, dev, torch.int32)
        state = promote_centers_shifted(state, mask, start)
        # no in-stage reset: every non-center is already unreached, and a
        # reset would zero the shifts
        state, gs = _grow(backend, state, max_delta, 0, num_it, "complete",
                          metrics)
        state = cover(state, max_delta)
        # the centers drawn and the nodes left uncovered stay on the
        # device (the reference reads them with its stats): no read here
        sp.set(supersteps=gs.steps,
               kernel_launches=backend.launches - launches0,
               dma_stall_blocks=metrics.dma_stall_blocks)
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

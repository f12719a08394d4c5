"""Diameter estimators over a ``GraphSession``, the port of the JAX
package's ``core/estimators.py``. Each is a ``DiameterEstimator``
(``estimate(session) -> DiameterEstimate``) on the session's resident
buffers, so methods compare on one graph without a re-upload (the paper's
Table 3):

  * ``ClusterQuotientEstimator`` — decompose (CLUSTER, or CLUSTER2 with
    ``use_cluster2``) -> device quotient -> batched multi-source solve.
    Conservative UPPER bound (Phi_approx >= Phi(G) when connected).
  * ``CascadeEstimator`` — the same, decomposing the quotient again while
    it has more than ``tau_solve`` clusters; ``levels=0`` is the flat
    pipeline field for field.
  * ``DynamicQuotientEstimator`` — the same bound from the decomposition
    a session maintains under ``apply_updates`` (``core/dynamic.py``),
    with the quotient refreshed incrementally and the solve cached until
    the next update.
  * ``DeltaSteppingEstimator`` — the paper's competitor: one SSSP from a
    random source gives ``ecc <= Phi <= 2 ecc``; ``delta=None`` is
    Bellman-Ford.
  * ``LowerBoundEstimator`` — repeated SSSP hopping to the farthest node.
    LOWER bound; its first hop also gives ``upper = 2 ecc``.
  * ``IntervalEstimator`` — runs a panel and returns a certified
    ``[lower, upper]`` bracket.

``PipelineMetrics`` counts every host read of a query. The port reads once
per chunk of supersteps where the reference reads once per stage (or once
per SSSP), so its counts are higher; they are counted, not forced equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (ClassVar, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np

from repro_torch.common import Timer, get_logger
from repro_torch.core import sssp
from repro_torch.core.backend import SingleDeviceBackend
from repro_torch.core.chunked import DEFAULT_CHUNK
from repro_torch.core.cluster import cluster, cluster2
from repro_torch.core.engine import (Decomposition, resolve_engine_mode,
                                     run_cluster, run_oneshot)
from repro_torch.core.quotient import (
    build_quotient_device,
    build_quotient_from_level,
    build_quotient_numpy,
    fetch_quotient_counters,
    quotient_as_edgelist,
    quotient_diameter,
    solve_device_quotient,
)
from repro_torch.core.session import GraphSession, tau_for
from repro_torch.runtime import telemetry

log = get_logger("repro_torch.estimators")


@dataclass
class PipelineMetrics:
    """Host-read accounting for one estimator query."""

    decompose_syncs: int = 0   # stage opens, redraws and grow-chunk reads
    finalize_syncs: int = 0    # packed final-plane read (1 / decomposition)
    checkpoint_syncs: int = 0  # reads of stage-boundary checkpoint saves;
                               # NOT in total_host_syncs (a durability
                               # knob, not a round of the algorithm)
    quotient_syncs: int = 0    # (k, m, max_w, w_sum) counter read
    solve_syncs: int = 0       # solve chunk reads + the packed result read
    solve_supersteps: int = 0  # device BF supersteps inside the solve
    n_quotient_edges: int = 0  # quotient edge count
    kernel_launches: int = 0   # hand-written CUDA launches in the
                               # decomposition (edge_relax or megakernel)
    kernel_supersteps: int = 0  # supersteps run inside fused calls
    dma_stall_blocks: int = 0   # rows the fused calls skipped
    solve_int64: int = 0       # 1 when the solve needed int64 distances
    # host-clock seconds per phase; each phase ends in a guard.fetch, so
    # the device work it queued is included
    decompose_seconds: float = 0.0
    quotient_seconds: float = 0.0
    solve_seconds: float = 0.0
    # cascade accounting (CascadeEstimator): one entry per EXTRA level (the
    # flat pipeline is level 0 and leaves them empty, so a level-0 cascade
    # is field-identical to ClusterQuotientEstimator); lists concatenate
    # under ``+`` as the counters add
    cascade_levels: int = 0     # extra decomposition levels run
    level_syncs: List[int] = field(default_factory=list)       # host reads
    level_supersteps: List[int] = field(default_factory=list)  # grow steps
    level_clusters: List[int] = field(default_factory=list)    # quotient k
                                                               # after it
    level_seconds: List[float] = field(default_factory=list)   # host clock

    @property
    def total_host_syncs(self) -> int:
        return (self.decompose_syncs + self.finalize_syncs
                + self.quotient_syncs + self.solve_syncs)

    def __add__(self, other: "PipelineMetrics") -> "PipelineMetrics":
        if not isinstance(other, PipelineMetrics):
            return NotImplemented
        return PipelineMetrics(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)})

    def __radd__(self, other) -> "PipelineMetrics":
        if other == 0:  # sum([...]) with the default start
            return self
        return self.__add__(other)

    @staticmethod
    def merge(items) -> "PipelineMetrics":
        return sum((m for m in items if m is not None), PipelineMetrics())


@dataclass
class DiameterEstimate:
    phi_approx: int
    phi_quotient: int
    radius: int
    n_clusters: int
    growing_steps: int
    n_stages: int
    delta_end: int
    seconds: float
    connected: bool
    pipeline: Optional[PipelineMetrics] = None
    quotient_ecc: Optional[np.ndarray] = None
    method: str = "cluster-quotient"
    lower: Optional[int] = None
    upper: Optional[int] = None
    decomposition: Optional[Decomposition] = None
    dist: Optional[np.ndarray] = None  # SSSP estimators: the distance plane
                                       # from the source


@dataclass
class DiameterInterval:
    """Certified diameter bracket from a panel of estimators."""

    lower: int
    upper: int
    connected: bool
    estimates: Dict[str, DiameterEstimate]
    pipeline: PipelineMetrics
    seconds: float


@runtime_checkable
class DiameterEstimator(Protocol):
    """One diameter-query method over a resident ``GraphSession``."""

    name: str

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        ...


# ---------------------------------------------------------------------------
# the paper pipeline
# ---------------------------------------------------------------------------


def _cascade_quotient_solve(edges, dec: Decomposition, backend,
                            pm: PipelineMetrics, cfg=None, tau_solve: int = 1,
                            max_levels: int = 0, level_mode: str = "stages"):
    """Quotient + solve on the device, with the multi-level cascade (the
    decomposition applied recursively until the quotient is small); the
    defaults, ``max_levels = 0``, are the flat pipeline.

    While the quotient has more than ``tau_solve`` clusters and levels
    remain, re-enter the engine ON THE QUOTIENT: rescale its int64 weights
    into int32 (``quotient_as_edgelist``, ceiling division), decompose it
    on a plain ``SingleDeviceBackend`` over the resident level arrays
    (seed ``cfg.seed + level``), and take its quotient. Level radii
    accumulate into the upper bound

        Phi(G) <= 2 R_0 + sum_{l>=1} S_l * 2 R_l + S_L * diam(Q_L)

    with S_l the cumulative rescale. Returns (phi_quotient_tail, ecc,
    connected, extra_steps), the tail being everything but level 0's
    ``2 R_0``.
    """
    with Timer() as t, telemetry.span("quotient.build") as sp:
        dq = build_quotient_device(edges, dec, backend)
        if dq is None:  # no nodes or no edges: the quotient is trivially empty
            k = dec.n_clusters
            return 0, np.zeros(k, np.int64), k <= 1, 0
        k, m, wmax, wsum = fetch_quotient_counters(dq)
        sp.set(clusters=k, edges=m)
    pm.quotient_seconds += t.seconds
    pm.quotient_syncs += 1
    pm.n_quotient_edges = m
    scale_total = 1
    radius_tail = 0   # sum_{l>=1} S_l * 2 R_l
    extra_steps = 0
    level = 0
    while level < max_levels and k > max(tau_solve, 1) and m > 0:
        level += 1
        with Timer() as t, telemetry.span("cascade.level", level=level) as sp:
            lv = quotient_as_edgelist(dq, k, m, wmax, wsum)
            be = SingleDeviceBackend.from_device(lv.n_nodes, lv.src, lv.dst,
                                                 lv.weight)
            tau_l = tau_for(k, cfg.tau_fraction)
            if level_mode == "oneshot":
                dec_l = run_oneshot(
                    None, be, tau_l, gamma=cfg.gamma, seed=cfg.seed + level,
                    deterministic=cfg.deterministic,
                    max_steps_per_phase=cfg.max_steps_per_phase,
                    max_delta=lv.weight_sum + 1)
            else:
                dec_l = run_cluster(
                    None, be, tau_l, gamma=cfg.gamma, variant=cfg.variant,
                    delta0=max(lv.weight_sum // max(m, 1), 1),
                    seed=cfg.seed + level, max_stages=cfg.max_stages,
                    max_steps_per_phase=cfg.max_steps_per_phase,
                    max_delta=lv.weight_sum + 1)
            scale_total *= lv.scale
            radius_tail += scale_total * 2 * dec_l.radius
            extra_steps += dec_l.growing_steps
            ml = dec_l.metrics
            pm.decompose_syncs += ml.host_syncs
            pm.finalize_syncs += ml.finalize_syncs
            dq = build_quotient_from_level(lv, dec_l)
            k, m, wmax, wsum = fetch_quotient_counters(dq)
            pm.quotient_syncs += 1
            sp.set(clusters=k, supersteps=dec_l.growing_steps,
                   syncs=ml.host_syncs + ml.finalize_syncs + 1)
        pm.level_syncs.append(ml.host_syncs + ml.finalize_syncs + 1)
        pm.level_supersteps.append(dec_l.growing_steps)
        pm.level_clusters.append(k)
        pm.level_seconds.append(t.seconds)
        log.info("cascade level %d: %d clusters -> %d (scale=%d steps=%d)",
                 level, lv.n_nodes, k, lv.scale, dec_l.growing_steps)
        if k == lv.n_nodes:
            # no shrinkage (all singletons): further levels would repeat it
            break
    pm.cascade_levels = level
    if k <= 1:
        return radius_tail, np.zeros(k, np.int64), True, extra_steps
    with Timer() as t, telemetry.span("quotient.solve", clusters=k) as sp:
        sol = solve_device_quotient(dq, k, m, wmax)
        sp.set(supersteps=sol.supersteps)
    pm.solve_seconds += t.seconds
    pm.solve_syncs += sol.reads
    pm.solve_supersteps = sol.supersteps
    pm.solve_int64 = int(sol.dtype == "int64")
    return (radius_tail + scale_total * sol.diameter,
            np.asarray(sol.ecc, np.int64) * scale_total, sol.connected,
            extra_steps)


def _resolve_query_cfg(session: GraphSession, est) -> Tuple[object, int]:
    """Apply an estimator's per-query overrides and resolve tau."""
    cfg = session.cfg
    delta_init = est.delta_init
    if delta_init is not None:
        delta_init = str(session.resolve_delta_init(delta_init))
    overrides = {k: v for k, v in (
        ("variant", est.variant), ("seed", est.seed),
        ("delta_init", delta_init), ("use_cluster2", est.use_cluster2),
        ("mode", est.mode)) if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # "auto" resolves against the session's autotuning record (if any);
    # bad names raise before any device work
    mode = resolve_engine_mode(cfg.mode, session.tuning)
    if mode != cfg.mode:
        cfg = dataclasses.replace(cfg, mode=mode)
    tau = est.tau if est.tau is not None else session.tau
    if tau < 1:
        raise ValueError(f"tau must be >= 1, got {tau}")
    return cfg, tau


def _run_decomposition(session: GraphSession, cfg, tau: int,
                       pm: PipelineMetrics) -> Decomposition:
    """Level-0 decomposition on the session's resident backend."""
    with Timer() as t:
        if cfg.use_cluster2:
            dec = cluster2(
                session.edges, tau, gamma=cfg.gamma, seed=cfg.seed,
                delta_init=cfg.delta_init, backend=session.backend,
                uniform_fn=session.uniform_fn)
        else:
            dec = cluster(
                session.edges, tau, gamma=cfg.gamma, variant=cfg.variant,
                delta_init=cfg.delta_init, seed=cfg.seed,
                max_stages=cfg.max_stages,
                max_steps_per_phase=cfg.max_steps_per_phase,
                backend=session.backend, uniform_fn=session.uniform_fn,
                mode=cfg.mode, deterministic=cfg.deterministic,
                checkpointer=session.checkpointer,
            )
    pm.decompose_seconds += t.seconds
    m = dec.metrics
    pm.decompose_syncs = m.host_syncs
    pm.finalize_syncs = m.finalize_syncs
    pm.checkpoint_syncs = m.checkpoint_syncs
    pm.kernel_launches = m.kernel_launches
    pm.kernel_supersteps = m.kernel_supersteps
    pm.dma_stall_blocks = m.dma_stall_blocks
    return dec


def _package_estimate(method: str, dec: Decomposition, phi_q: int,
                      connected: bool, pm: PipelineMetrics, ecc,
                      seconds: float, extra_steps: int = 0) -> DiameterEstimate:
    phi = phi_q + 2 * dec.radius
    if not connected:
        log.warning("graph is disconnected: phi_approx=%d only bounds "
                    "finite-distance pairs", phi)
    log.info("phi_approx=%d (quotient=%d radius=%d clusters=%d steps=%d "
             "host_syncs=%d launches=%d) in %.2fs", phi, phi_q, dec.radius,
             dec.n_clusters, dec.growing_steps + extra_steps,
             pm.total_host_syncs, pm.kernel_launches, seconds)
    return DiameterEstimate(
        phi_approx=phi, phi_quotient=phi_q, radius=dec.radius,
        n_clusters=dec.n_clusters,
        growing_steps=dec.growing_steps + extra_steps,
        n_stages=dec.n_stages, delta_end=dec.delta_end, seconds=seconds,
        connected=connected, pipeline=pm, quotient_ecc=ecc, method=method,
        upper=phi, decomposition=dec)


@dataclass
class ClusterQuotientEstimator:
    """Paper pipeline: Phi_approx(G) = Phi(G_C) + 2 R (conservative upper),
    with the quotient and its solve on the session's device.

    ``tau``/``variant``/``seed``/``delta_init``/``use_cluster2``/``mode``
    override the session defaults per query (``deterministic`` comes from
    the session's config). ``solver="device"`` (default) runs the quotient
    and its solve on the device; ``solver="scipy"`` builds the quotient on
    the host and solves it with scipy (the oracle path; no
    ``quotient_ecc``).
    """

    name: ClassVar[str] = "cluster-quotient"

    tau: Optional[int] = None
    solver: str = "device"           # device | scipy
    variant: Optional[str] = None
    seed: Optional[int] = None
    delta_init: Optional[str] = None
    use_cluster2: Optional[bool] = None
    mode: Optional[str] = None       # stages | oneshot | auto

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        if self.solver not in ("device", "scipy"):
            raise ValueError(f"solver must be 'device' or 'scipy', got "
                             f"{self.solver!r}")
        cfg, tau = _resolve_query_cfg(session, self)
        pm = PipelineMetrics()
        with session.track_query(), Timer() as t:
            dec = _run_decomposition(session, cfg, tau, pm)
            if self.solver == "scipy":
                phi_q, connected = quotient_diameter(
                    build_quotient_numpy(session.edges, dec))
                ecc = None
            else:
                phi_q, ecc, connected, _ = _cascade_quotient_solve(
                    session.edges, dec, session.backend, pm)
        return _package_estimate(self.name, dec, phi_q, connected, pm, ecc,
                                 t.seconds)


@dataclass
class CascadeEstimator:
    """The paper pipeline applied recursively until the quotient fits the
    solve budget.

    Level 0 decomposes the session graph on its resident backend exactly
    as ``ClusterQuotientEstimator`` does (on the card: the kernel); while
    the quotient has more than ``tau_solve`` clusters (default: the
    session's) and ``levels`` allows, the engine re-enters ON THE QUOTIENT
    on a plain backend over the level's device arrays. ``n_clusters``,
    ``radius``, ``n_stages`` and ``delta_end`` describe level 0 (the levels
    are in ``pipeline.level_*``); ``quotient_ecc`` covers the last solved
    level. ``levels=0`` is field-identical to the flat pipeline.
    """

    name: ClassVar[str] = "cascade"

    levels: int = 2
    tau_solve: Optional[int] = None
    tau: Optional[int] = None
    variant: Optional[str] = None
    seed: Optional[int] = None
    delta_init: Optional[str] = None
    use_cluster2: Optional[bool] = None
    mode: Optional[str] = None        # level-0 engine mode
    level_mode: Optional[str] = None  # re-entrant levels' mode; None = the
                                      # level-0 mode

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        if self.levels < 0:
            raise ValueError(f"levels must be >= 0, got {self.levels}")
        tau_solve = (self.tau_solve if self.tau_solve is not None
                     else session.tau_solve)
        if tau_solve < 2:
            raise ValueError(f"tau_solve must be >= 2, got {tau_solve}")
        cfg, tau = _resolve_query_cfg(session, self)
        level_mode = resolve_engine_mode(
            self.level_mode if self.level_mode is not None else cfg.mode,
            session.tuning)
        pm = PipelineMetrics()
        with session.track_query(), Timer() as t:
            dec = _run_decomposition(session, cfg, tau, pm)
            phi_q, ecc, connected, extra = _cascade_quotient_solve(
                session.edges, dec, session.backend, pm, cfg, tau_solve,
                self.levels, level_mode=level_mode)
        return _package_estimate(self.name, dec, phi_q, connected, pm, ecc,
                                 t.seconds, extra_steps=extra)


@dataclass
class DynamicQuotientEstimator:
    """The query side of dynamic updates: ``Phi(G_C) + 2 R`` from the
    decomposition the session MAINTAINS under ``apply_updates`` instead of
    a new one per query. Only the quotient keys of clusters dirtied since
    the last solve are recomputed, and the solve is cached until the next
    update (a repeated query costs no device work). On a session that has
    not been updated it enters dynamic mode (one full decomposition, as
    the flat pipeline's first query). The bound is
    ``ClusterQuotientEstimator``'s: certified upper when connected."""

    name: ClassVar[str] = "dynamic-quotient"

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        from repro_torch.core import dynamic

        pm = PipelineMetrics()
        with session.track_query(), Timer() as t:
            st = dynamic.ensure_dynamic(session)
            phi_q, ecc, connected = dynamic.solve_session_quotient(session,
                                                                   pm)
        return _package_estimate(self.name, st.dec, phi_q, connected, pm,
                                 ecc, t.seconds)


# ---------------------------------------------------------------------------
# SSSP estimators (the competitor and the lower bound), on the session's
# resident edge arrays
# ---------------------------------------------------------------------------


def _trivial_estimate(method: str, n_nodes: int) -> DiameterEstimate:
    """Empty / single-node graphs: diameter 0, connected iff <= 1 node."""
    return DiameterEstimate(
        phi_approx=0, phi_quotient=0, radius=0, n_clusters=n_nodes,
        growing_steps=0, n_stages=0, delta_end=0, seconds=0.0,
        connected=n_nodes <= 1, pipeline=PipelineMetrics(),
        method=method, lower=0, upper=0 if n_nodes <= 1 else None)


def _sssp_from(session: GraphSession, source: int,
               delta: Optional[int]) -> sssp.SSSPResult:
    """One SSSP on the session's resident edge arrays: Bellman-Ford for
    ``delta=None``, else Δ-stepping. The distance dtype follows the
    provable bound (with delta headroom), as ``sssp.bellman_ford`` does."""
    src, dst, w = session.flat_device_edges()
    dtype, inf = sssp.sssp_dtype_for(session.n_nodes, session.max_weight,
                                     0 if delta is None else delta)
    with telemetry.span("sssp.solve", source=source) as sp:
        res = sssp._sssp_from(src, dst, w.to(dtype), source, session.n_nodes,
                              inf, DEFAULT_CHUNK, delta=delta)
        sp.set(supersteps=res.supersteps)
    return res


@dataclass
class DeltaSteppingEstimator:
    """2-approximation from one SSSP: ecc(source) <= Phi <= 2 ecc(source).

    ``delta=None`` (default) runs Bellman-Ford, the paper's best setting
    on a round-driven platform (Δ = inf); an int runs Δ-stepping with that
    bucket width. The source is ``default_rng(seed).integers(n)``, as the
    reference draws it.
    """

    name: ClassVar[str] = "delta-stepping"

    seed: int = 0
    delta: Optional[int] = None

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        if self.delta is not None and self.delta < 1:
            raise ValueError(f"delta must be >= 1, got {self.delta} "
                             "(use delta=None for Bellman-Ford)")
        n = session.n_nodes
        if n <= 1:
            with session.track_query():
                return _trivial_estimate(self.name, n)
        with session.track_query(), Timer() as t:
            s = int(np.random.default_rng(self.seed).integers(n))
            res = _sssp_from(session, s, self.delta)
        reached = res.dist < res.inf
        ecc = int(res.dist[reached].max())
        connected = bool(reached.all())
        pm = PipelineMetrics(solve_syncs=res.syncs,
                             solve_supersteps=res.supersteps,
                             solve_seconds=t.seconds)
        # on a disconnected input 2 ecc covers the source's component only,
        # so it is no certified upper bound (ecc stays a lower bound)
        return DiameterEstimate(
            phi_approx=2 * ecc, phi_quotient=0, radius=ecc, n_clusters=0,
            growing_steps=res.supersteps, n_stages=1,
            delta_end=0 if self.delta is None else self.delta,
            seconds=t.seconds,
            connected=connected, pipeline=pm, method=self.name, lower=ecc,
            upper=2 * ecc if connected else None, dist=res.dist)


@dataclass
class LowerBoundEstimator:
    """Farthest-point SSSP hopping (paper Table 1's Phi column): a certified
    LOWER bound; on connected inputs also ``upper = 2 * ecc(first source)``."""

    name: ClassVar[str] = "farthest-point"

    rounds: int = 4
    seed: int = 0

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        n = session.n_nodes
        if n <= 1:
            with session.track_query():
                return _trivial_estimate(self.name, n)
        with session.track_query(), Timer() as t:
            fp = sssp.farthest_point_lower_bound(
                *session.flat_device_edges(), n, session.max_weight,
                rounds=self.rounds, seed=self.seed)
        pm = PipelineMetrics(solve_syncs=fp.syncs, solve_supersteps=fp.supersteps)
        return DiameterEstimate(
            phi_approx=fp.lower, phi_quotient=0, radius=0, n_clusters=0,
            growing_steps=fp.supersteps, n_stages=fp.hops, delta_end=0,
            seconds=t.seconds, connected=fp.connected, pipeline=pm,
            method=self.name, lower=fp.lower,
            upper=2 * fp.first_ecc if fp.connected else None)


@dataclass
class IntervalEstimator:
    """Run a panel on ONE session and combine: lower = max of lower bounds,
    upper = min of upper bounds. Default panel: farthest-point + the
    cluster-quotient pipeline, or on a session in dynamic mode the
    maintained ``DynamicQuotientEstimator``."""

    name: ClassVar[str] = "interval"

    estimators: Tuple = ()

    def estimate(self, session: GraphSession) -> DiameterInterval:
        upper_est = (DynamicQuotientEstimator()
                     if session.dynamic is not None
                     else ClusterQuotientEstimator())
        panel = self.estimators or (LowerBoundEstimator(), upper_est)
        with Timer() as t:
            results: Dict[str, DiameterEstimate] = {}
            for e in panel:
                key, dup = e.name, 2
                while key in results:
                    key, dup = f"{e.name}#{dup}", dup + 1
                results[key] = e.estimate(session)
        lowers = [r.lower for r in results.values() if r.lower is not None]
        uppers = [r.upper for r in results.values() if r.upper is not None]
        if not uppers:
            raise ValueError("interval panel produced no upper bound")
        flags = {r.connected for r in results.values()}
        if len(flags) > 1:
            log.warning("estimators disagree on connectivity: %s",
                        {k: r.connected for k, r in results.items()})
        lower, upper = max(lowers, default=0), min(uppers)
        if lower > upper:
            raise AssertionError(
                f"certified bracket violated: lower {lower} > upper {upper}")
        return DiameterInterval(
            lower=lower, upper=upper, connected=all(flags), estimates=results,
            pipeline=PipelineMetrics.merge(r.pipeline for r in results.values()),
            seconds=t.seconds)

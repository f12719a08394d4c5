"""Diameter estimators over a ``GraphSession``, the port of the JAX
package's ``core/estimators.py`` (paper pipeline, farthest-point lower
bound and the certified interval).

  * ``ClusterQuotientEstimator`` — decompose -> device quotient -> batched
    multi-source solve. Conservative UPPER bound (Phi_approx >= Phi(G)
    when connected).
  * ``LowerBoundEstimator`` — repeated SSSP hopping to the farthest node.
    LOWER bound; its first hop also gives ``upper = 2 ecc``.
  * ``IntervalEstimator`` — runs a panel and returns a certified
    ``[lower, upper]`` bracket.

``PipelineMetrics`` counts every host read of a query. The port reads once
per chunk of supersteps where the reference reads once per stage, so its
counts are higher; they are counted, not forced equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Tuple

import numpy as np

from repro_torch.common import Timer, get_logger
from repro_torch.core.cluster import cluster
from repro_torch.core.engine import Decomposition, resolve_engine_mode
from repro_torch.core.quotient import (
    build_quotient_device,
    fetch_quotient_counters,
    solve_device_quotient,
)
from repro_torch.core.session import GraphSession
from repro_torch.core.sssp import farthest_point_lower_bound

log = get_logger("repro_torch.estimators")


@dataclass
class PipelineMetrics:
    """Host-read accounting for one estimator query."""

    decompose_syncs: int = 0   # stage opens, redraws and grow-chunk reads
    finalize_syncs: int = 0    # packed final-plane read (1 / decomposition)
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


@dataclass
class DiameterInterval:
    """Certified diameter bracket from a panel of estimators."""

    lower: int
    upper: int
    connected: bool
    estimates: Dict[str, DiameterEstimate]
    pipeline: PipelineMetrics
    seconds: float


# ---------------------------------------------------------------------------
# the paper pipeline
# ---------------------------------------------------------------------------


def _device_quotient_solve(edges, dec: Decomposition, backend,
                           pm: PipelineMetrics):
    """Quotient + local solve on the device. Returns
    (phi_quotient, eccentricities, connected)."""
    with Timer() as t:
        dq = build_quotient_device(edges, dec, backend)
        if dq is None:  # no nodes or no edges: the quotient is trivially empty
            k = dec.n_clusters
            return 0, np.zeros(k, np.int64), k <= 1
        k, m, wmax, _ = fetch_quotient_counters(dq)
    pm.quotient_seconds += t.seconds
    pm.quotient_syncs += 1
    pm.n_quotient_edges = m
    if k <= 1:
        return 0, np.zeros(k, np.int64), True
    with Timer() as t:
        sol = solve_device_quotient(dq, k, m, wmax)
    pm.solve_seconds += t.seconds
    pm.solve_syncs += sol.reads
    pm.solve_supersteps = sol.supersteps
    pm.solve_int64 = int(sol.dtype == "int64")
    return sol.diameter, sol.ecc, sol.connected


def _resolve_query_cfg(session: GraphSession, est) -> Tuple[object, int]:
    """Apply an estimator's per-query overrides and resolve tau."""
    cfg = session.cfg
    delta_init = est.delta_init
    if delta_init is not None:
        delta_init = str(session.resolve_delta_init(delta_init))
    overrides = {k: v for k, v in (
        ("variant", est.variant), ("seed", est.seed),
        ("delta_init", delta_init), ("mode", est.mode)) if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # bad names raise before any device work; "auto" -> "stages"
    mode = resolve_engine_mode(cfg.mode)
    if mode != cfg.mode:
        cfg = dataclasses.replace(cfg, mode=mode)
    tau = est.tau if est.tau is not None else session.tau
    if tau < 1:
        raise ValueError(f"tau must be >= 1, got {tau}")
    return cfg, tau


def _run_decomposition(session: GraphSession, cfg, tau: int,
                       pm: PipelineMetrics) -> Decomposition:
    with Timer() as t:
        dec = cluster(
            session.edges, tau, gamma=cfg.gamma, variant=cfg.variant,
            delta_init=cfg.delta_init, seed=cfg.seed,
            max_stages=cfg.max_stages,
            max_steps_per_phase=cfg.max_steps_per_phase,
            backend=session.backend, uniform_fn=session.uniform_fn,
            mode=cfg.mode, deterministic=cfg.deterministic,
        )
    pm.decompose_seconds += t.seconds
    m = dec.metrics
    pm.decompose_syncs = m.host_syncs
    pm.finalize_syncs = m.finalize_syncs
    pm.kernel_launches = m.kernel_launches
    pm.kernel_supersteps = m.kernel_supersteps
    pm.dma_stall_blocks = m.dma_stall_blocks
    return dec


@dataclass
class ClusterQuotientEstimator:
    """Paper pipeline: Phi_approx(G) = Phi(G_C) + 2 R (conservative upper),
    with the quotient and its solve on the session's device.

    ``tau``/``variant``/``seed``/``delta_init``/``mode`` override the
    session defaults per query (``deterministic`` comes from the session's
    config).
    """

    name: ClassVar[str] = "cluster-quotient"

    tau: Optional[int] = None
    variant: Optional[str] = None
    seed: Optional[int] = None
    delta_init: Optional[str] = None
    mode: Optional[str] = None       # stages | oneshot | auto

    def estimate(self, session: GraphSession) -> DiameterEstimate:
        cfg, tau = _resolve_query_cfg(session, self)
        pm = PipelineMetrics()
        with session.track_query(), Timer() as t:
            dec = _run_decomposition(session, cfg, tau, pm)
            phi_q, ecc, connected = _device_quotient_solve(
                session.edges, dec, session.backend, pm)
            if not connected:
                log.warning("graph is disconnected: phi_approx=%d only bounds "
                            "finite-distance pairs", phi_q + 2 * dec.radius)
        phi = phi_q + 2 * dec.radius
        log.info("phi_approx=%d (quotient=%d radius=%d clusters=%d steps=%d "
                 "host_syncs=%d launches=%d) in %.2fs", phi, phi_q,
                 dec.radius, dec.n_clusters, dec.growing_steps,
                 pm.total_host_syncs, pm.kernel_launches, t.seconds)
        return DiameterEstimate(
            phi_approx=phi, phi_quotient=phi_q, radius=dec.radius,
            n_clusters=dec.n_clusters, growing_steps=dec.growing_steps,
            n_stages=dec.n_stages, delta_end=dec.delta_end,
            seconds=t.seconds, connected=connected, pipeline=pm,
            quotient_ecc=ecc, method=self.name, upper=phi,
            decomposition=dec)


# ---------------------------------------------------------------------------
# the SSSP lower bound, on the session's resident edge arrays
# ---------------------------------------------------------------------------


def _trivial_estimate(method: str, n_nodes: int) -> DiameterEstimate:
    """Empty / single-node graphs: diameter 0, connected iff <= 1 node."""
    return DiameterEstimate(
        phi_approx=0, phi_quotient=0, radius=0, n_clusters=n_nodes,
        growing_steps=0, n_stages=0, delta_end=0, seconds=0.0,
        connected=n_nodes <= 1, pipeline=PipelineMetrics(),
        method=method, lower=0, upper=0 if n_nodes <= 1 else None)


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
            fp = farthest_point_lower_bound(
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
    cluster-quotient pipeline."""

    name: ClassVar[str] = "interval"

    estimators: Tuple = ()

    def estimate(self, session: GraphSession) -> DiameterInterval:
        panel = self.estimators or (LowerBoundEstimator(),
                                    ClusterQuotientEstimator())
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

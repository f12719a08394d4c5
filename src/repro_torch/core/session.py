"""GraphSession: a resident-graph handle for query-many serving, the port of
the JAX package's ``core/session.py`` (without stores, spill, dynamic
updates or autotune).

``open_session(edges, ...)`` uploads the edges and builds the backend once
on the session's device; every estimator query afterwards runs against
the resident buffers. ``SessionMetrics`` counts the expensive open-path
events (backend builds, edge uploads) so a warm query can be told apart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.common import GraphEngineConfig, get_logger, resolve_device
from repro_torch.core.backend import RelaxBackend, make_backend
from repro_torch.core.cluster import _initial_delta
from repro_torch.core.engine import UniformFn, resolve_engine_mode
from repro_torch.graph.structures import EdgeList

log = get_logger("repro_torch.session")


def tau_for(n_nodes: int, fraction: float = 1e-3, minimum: int = 4) -> int:
    """Paper Section 5: tau so the quotient has ~ n/1000 nodes:
    ``n * fraction / log n`` with a floor."""
    logn = max(math.log(max(n_nodes, 2)), 1.0)
    return max(int(n_nodes * fraction / logn), minimum)


@dataclass
class SessionMetrics:
    """Open-vs-query cost accounting."""

    sessions_opened: int = 0
    backend_builds: int = 0   # RelaxBackend constructions
    edge_uploads: int = 0     # host->device edge-array placements
    queries: int = 0          # estimator runs against a session
    warm_queries: int = 0     # queries that triggered no build and no upload


class GraphSession:
    """One resident graph: edges on the device, backend built, ready to
    query. ``estimate(estimator)`` runs any estimator against it; with no
    argument it runs the paper pipeline (``ClusterQuotientEstimator``)."""

    def __init__(
        self,
        edges: EdgeList,
        cfg: Optional[GraphEngineConfig] = None,
        *,
        tau: Optional[int] = None,
        backend: Union[str, RelaxBackend, None] = None,
        device="cuda",
        metrics: Optional[SessionMetrics] = None,
        uniform_fn: Optional[UniformFn] = None,
    ):
        if tau is not None and tau < 1:
            raise ValueError(f"tau must be >= 1, got {tau}")
        self.cfg = cfg or GraphEngineConfig()
        # unknown modes raise here, before any device work; "auto" resolves
        # to "stages" (the port has no autotuning record)
        mode = resolve_engine_mode(self.cfg.mode)
        if mode != self.cfg.mode:
            self.cfg = dataclasses.replace(self.cfg, mode=mode)
        self.metrics = metrics if metrics is not None else SessionMetrics()
        self.metrics.sessions_opened += 1
        if backend is None:
            backend = self.cfg.backend
        if isinstance(backend, str):
            self.device = resolve_device(device)
            backend = make_backend(edges, backend, device=self.device,
                                   fuse=self.cfg.fuse_supersteps)
        else:
            self.device = backend.device
        # a prebuilt backend counts too: its construction and upload are
        # this session's open cost
        self.metrics.backend_builds += 1
        self.metrics.edge_uploads += 1
        self.backend: Optional[RelaxBackend] = backend
        self._edges: Optional[EdgeList] = edges
        self._n_nodes = edges.n_nodes
        self._n_edges = edges.n_edges
        self.tau = tau if tau is not None else tau_for(edges.n_nodes,
                                                       self.cfg.tau_fraction)
        # center-draw override (tests inject the reference's uniforms)
        self.uniform_fn = uniform_fn
        self._max_weight: Optional[int] = None
        self._closed = False
        log.debug("opened session: %d nodes, %d edges, tau=%d, backend=%s, "
                  "device=%s", edges.n_nodes, edges.n_edges, self.tau,
                  backend.kind, self.device)

    @property
    def edges(self) -> EdgeList:
        self._check_open()
        return self._edges

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def max_weight(self) -> int:
        """Largest edge weight (the SSSP estimators pick their dtype from
        it), cached for the session's lifetime."""
        self._check_open()
        if self._max_weight is None:
            self._max_weight = (int(self._edges.weight.max())
                                if self._n_edges else 1)
        return self._max_weight

    def resolve_delta_init(self, mode: str) -> int:
        self._check_open()
        return _initial_delta(self._edges, mode)

    def flat_device_edges(self) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """Flat device ``(src, dst, weight)`` views of the backend's own
        buffers (the kernel backend's CSR is the same edge set in (dst, src)
        order) — no re-upload."""
        self._check_open()
        return self.backend.flat_edges()

    def estimate(self, estimator=None):
        self._check_open()
        if estimator is None:
            from repro_torch.core.estimators import ClusterQuotientEstimator

            estimator = ClusterQuotientEstimator()
        return estimator.estimate(self)

    @contextlib.contextmanager
    def track_query(self):
        """Counts the query; warm when it triggered no build and no upload."""
        self._check_open()
        m = self.metrics
        b0, u0 = m.backend_builds, m.edge_uploads
        m.queries += 1
        yield
        if m.backend_builds == b0 and m.edge_uploads == u0:
            m.warm_queries += 1

    def _check_open(self):
        if self._closed:
            raise RuntimeError("session is closed")

    def close(self):
        """Drop the device buffers and the host edges. Idempotent."""
        self.backend = None
        self._edges = None
        self._closed = True

    def __enter__(self) -> "GraphSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_session(
    edges: EdgeList,
    cfg: Optional[GraphEngineConfig] = None,
    *,
    tau: Optional[int] = None,
    backend: Union[str, RelaxBackend, None] = None,
    device="cuda",
    metrics: Optional[SessionMetrics] = None,
    uniform_fn: Optional[UniformFn] = None,
) -> GraphSession:
    """Open a graph once for many queries on ``device`` (default CUDA; it
    raises when no GPU is present). ``backend`` is "single", "kernel"
    (default, from ``cfg.backend``) or a prebuilt backend."""
    return GraphSession(edges, cfg, tau=tau, backend=backend, device=device,
                        metrics=metrics, uniform_fn=uniform_fn)

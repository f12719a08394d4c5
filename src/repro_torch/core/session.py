"""GraphSession: a resident-graph handle for query-many serving, the port of
the JAX package's ``core/session.py`` (without its store-backed sessions,
spill or checkpoints).

``open_session(edges, ...)`` uploads the edges and builds the backend once
on the session's device; every estimator query afterwards runs against
the resident buffers. ``SessionMetrics`` counts the expensive open-path
events (backend builds, edge uploads) so a warm query can be told apart.

``tau_solve`` is the cascade's solve budget: ``CascadeEstimator`` keeps
decomposing the quotient while it has more clusters than this.
``autotune`` ("off" | "auto" | "record") derives tau, tau_solve, the
cascade depth, delta_init, the fusion depth and the engine mode from one
statistics pass over the edges (``core/autotune.py``), keeping every knob
passed explicitly.

``SessionPool`` serves many graphs: each graph's edge arrays are padded
to a bucket multiple with inert self-loops (``_pad_edges``), and its
symbolic ``delta_init`` is resolved from the real edges first, so a
pooled estimate equals an unpooled one. All pooled sessions share one
``SessionMetrics``.

Resident graphs are mutable: ``session.apply_updates(UpdateBatch)``
absorbs insertions, reweights and deletions into an edge store on the
device and repairs the maintained decomposition (``core/dynamic.py``);
from then on ``estimate()`` defaults to ``DynamicQuotientEstimator``.
``rebuild_fraction`` is the dead-node fraction above which a batch
decomposes the graph again.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common import (GraphEngineConfig, get_logger, next_multiple,
                                resolve_device)
from repro_torch.core.backend import RelaxBackend, make_backend
from repro_torch.core.cluster import _initial_delta
from repro_torch.core.engine import UniformFn, resolve_engine_mode
from repro_torch.graph.structures import EdgeList

log = get_logger("repro_torch.session")

EDGE_BUCKET = 256  # pooled sessions pad edge arrays to a multiple of this

# the cascade's default quotient-solve budget (clusters), as the reference's
DEFAULT_TAU_SOLVE = 1024

AUTOTUNE_MODES = ("off", "auto", "record")

# dynamic updates: a delete/increase batch whose dead nodes exceed this
# fraction of n decomposes again instead of repairing (the reference's)
DEFAULT_REBUILD_FRACTION = 0.25


def tau_for(n_nodes: int, fraction: float = 1e-3, minimum: int = 4) -> int:
    """Paper Section 5: tau so the quotient has ~ n/1000 nodes:
    ``n * fraction / log n`` with a floor."""
    logn = max(math.log(max(n_nodes, 2)), 1.0)
    return max(int(n_nodes * fraction / logn), minimum)


@dataclass
class SessionMetrics:
    """Open-vs-query cost accounting, shared across a pool's sessions."""

    sessions_opened: int = 0
    backend_builds: int = 0   # RelaxBackend constructions
    edge_uploads: int = 0     # host->device edge-array placements
    queries: int = 0          # estimator runs against a session
    warm_queries: int = 0     # queries that triggered no build and no upload


class GraphSession:
    """One resident graph: edges on the device, backend built, ready to
    query. ``estimate(estimator)`` runs any estimator against it; with no
    argument it runs the paper pipeline (``ClusterQuotientEstimator``), or
    on an autotuned session whose record asks for a cascade,
    ``CascadeEstimator(levels=tuning.levels)``."""

    def __init__(
        self,
        edges: EdgeList,
        cfg: Optional[GraphEngineConfig] = None,
        *,
        tau: Optional[int] = None,
        tau_solve: Optional[int] = None,
        backend: Union[str, RelaxBackend, None] = None,
        device="cuda",
        metrics: Optional[SessionMetrics] = None,
        uniform_fn: Optional[UniformFn] = None,
        delta_stats: Optional[Dict[str, int]] = None,
        autotune: Optional[str] = None,
        rebuild_fraction: Optional[float] = None,
    ):
        if tau is not None and tau < 1:
            raise ValueError(f"tau must be >= 1, got {tau}")
        if tau_solve is not None and tau_solve < 2:
            raise ValueError(f"tau_solve must be >= 2, got {tau_solve}")
        if rebuild_fraction is not None and not 0.0 <= rebuild_fraction <= 1.0:
            raise ValueError(
                f"rebuild_fraction must be in [0, 1], got {rebuild_fraction}")
        self.cfg = cfg or GraphEngineConfig()
        tune = autotune if autotune is not None else self.cfg.autotune
        if tune not in AUTOTUNE_MODES:
            raise ValueError(
                f"autotune must be off | auto | record, got {tune!r}")
        if backend is None:
            backend = self.cfg.backend
        self.device = (resolve_device(device) if isinstance(backend, str)
                       else backend.device)
        # symbolic delta_init modes resolved over the REAL edges (set by
        # SessionPool, so padding self-loops never skew "avg"/"min")
        self._delta_stats = delta_stats

        # -- autotuner: only symbolic/default knobs are tuned ---------------
        self.tuning = None
        if tune != "off" and edges.n_nodes > 0 and edges.n_edges > 0:
            from repro_torch.core.autotune import get_tuning

            kind = backend if isinstance(backend, str) else backend.kind
            self.tuning = get_tuning(edges, backend=kind, device=self.device,
                                     record=(tune == "record"))
            if self.cfg.delta_init in ("avg", "min"):
                self.cfg = dataclasses.replace(
                    self.cfg, delta_init=str(self.tuning.delta_init))
        # an explicit "stages"/"oneshot" always wins; "auto" defers to the
        # record; unknown names raise here, before any device work
        mode = resolve_engine_mode(self.cfg.mode, self.tuning)
        if mode != self.cfg.mode:
            self.cfg = dataclasses.replace(self.cfg, mode=mode)

        self.metrics = metrics if metrics is not None else SessionMetrics()
        self.metrics.sessions_opened += 1
        if isinstance(backend, str):
            fuse = self.cfg.fuse_supersteps or (
                self.tuning.fuse if self.tuning is not None else 0)
            backend = make_backend(edges, backend, device=self.device,
                                   fuse=fuse)
        # a prebuilt backend counts too: its construction and upload are
        # this session's open cost
        self.metrics.backend_builds += 1
        self.metrics.edge_uploads += 1
        self.backend: Optional[RelaxBackend] = backend
        self._edges: Optional[EdgeList] = edges
        self._edges_fn = None   # dynamic mode: the lazy host-mirror thunk
        self._n_nodes = edges.n_nodes
        self._n_edges = edges.n_edges
        if tau is not None:
            self.tau = tau
        elif self.tuning is not None:
            self.tau = self.tuning.tau
        else:
            self.tau = tau_for(edges.n_nodes, self.cfg.tau_fraction)
        if tau_solve is not None:
            self.tau_solve = tau_solve
        elif self.tuning is not None:
            self.tau_solve = self.tuning.tau_solve
        else:
            self.tau_solve = DEFAULT_TAU_SOLVE
        # center-draw override (tests inject the reference's uniforms)
        self.uniform_fn = uniform_fn
        self._max_weight: Optional[int] = None
        self.rebuild_fraction = (rebuild_fraction
                                 if rebuild_fraction is not None
                                 else DEFAULT_REBUILD_FRACTION)
        self._dynamic = None    # core.dynamic.DynamicState once updated
        self._closed = False
        log.debug("opened session: %d nodes, %d edges, tau=%d, backend=%s, "
                  "device=%s", edges.n_nodes, edges.n_edges, self.tau,
                  backend.kind, self.device)

    @property
    def edges(self) -> EdgeList:
        """Host edge mirror. In dynamic mode it is materialized from the
        store's host buffers on access and kept until the next update."""
        self._check_open()
        if self._edges is None and self._edges_fn is not None:
            self._edges = self._edges_fn()
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
        it), cached for the session's lifetime; pooled padding carries
        w = 1 and cannot change it."""
        self._check_open()
        if self._max_weight is None:
            self._max_weight = (int(self.edges.weight.max())
                                if self._n_edges else 1)
        return self._max_weight

    def resolve_delta_init(self, mode: str) -> int:
        """A symbolic Delta_init ("avg" | "min" | numeric) for this graph;
        a pooled session answers from its real (pre-padding) edges."""
        self._check_open()
        if self._delta_stats is not None and mode in self._delta_stats:
            return self._delta_stats[mode]
        return _initial_delta(self.edges, mode)

    def flat_device_edges(self) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """Flat device ``(src, dst, weight)`` views of the backend's own
        buffers (the kernel backend's CSR is the same edge set in (dst, src)
        order), or in dynamic mode the store's arrays — no re-upload."""
        self._check_open()
        if self._dynamic is not None:
            store = self._dynamic.store
            return store.src, store.dst, store.weight
        return self.backend.flat_edges()

    def estimate(self, estimator=None):
        """Run ``estimator``; by default the paper pipeline, the record's
        cascade on an autotuned session, or in dynamic mode the maintained
        ``DynamicQuotientEstimator``."""
        self._check_open()
        if estimator is None:
            from repro_torch.core.estimators import (CascadeEstimator,
                                                     ClusterQuotientEstimator,
                                                     DynamicQuotientEstimator)

            if self._dynamic is not None:
                estimator = DynamicQuotientEstimator()
            elif self.tuning is not None and self.tuning.levels > 0:
                estimator = CascadeEstimator(levels=self.tuning.levels)
            else:
                estimator = ClusterQuotientEstimator()
        return estimator.estimate(self)

    @property
    def dynamic(self):
        """The session's ``DynamicState`` (None until the first
        ``apply_updates`` or ``DynamicQuotientEstimator`` query)."""
        return self._dynamic

    def apply_updates(self, batch, **kw):
        """Absorb an ``UpdateBatch`` into the resident graph in place and
        repair the maintained decomposition (``core/dynamic.py``;
        ``tighten_cap`` and ``regrow_cap`` bound its relaxes). Returns an
        ``UpdateReport``."""
        self._check_open()
        from repro_torch.core.dynamic import apply_updates

        return apply_updates(self, batch, **kw)

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
        """Drop the device buffers, the dynamic state and the host edges.
        Idempotent."""
        self.backend = None
        self._dynamic = None
        self._edges = None
        self._edges_fn = None
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
    tau_solve: Optional[int] = None,
    backend: Union[str, RelaxBackend, None] = None,
    device="cuda",
    metrics: Optional[SessionMetrics] = None,
    uniform_fn: Optional[UniformFn] = None,
    autotune: Optional[str] = None,
    rebuild_fraction: Optional[float] = None,
) -> GraphSession:
    """Open a graph once for many queries on ``device`` (default CUDA; it
    raises when no GPU is present). ``backend`` is "single", "kernel"
    (default, from ``cfg.backend``) or a prebuilt backend; ``tau_solve``
    (>= 2, default ``DEFAULT_TAU_SOLVE``) is the cascade's solve budget;
    ``autotune`` ("off" | "auto" | "record") overrides ``cfg.autotune``;
    ``rebuild_fraction`` (in [0, 1], default
    ``DEFAULT_REBUILD_FRACTION``) is the dynamic updates' threshold."""
    return GraphSession(edges, cfg, tau=tau, tau_solve=tau_solve,
                        backend=backend, device=device, metrics=metrics,
                        uniform_fn=uniform_fn, autotune=autotune,
                        rebuild_fraction=rebuild_fraction)


# ---------------------------------------------------------------------------
# bucketed padding (pooled serving)
# ---------------------------------------------------------------------------


def _pad_edges(edges: EdgeList, e_pad: int) -> EdgeList:
    """Pad the edge arrays to ``e_pad`` with inert self-loops (0 -> 0,
    w = 1).

    A self-loop never wins a relaxation (d[0] + 1 > d[0]), is never a cross
    edge of the quotient and never shortens an SSSP distance, so the
    decomposition and every estimate equal the unpadded graph's. On the
    kernel backend the loops join row 0 of the CSR, which past
    ``LONG_ROW`` in-edges the kernels scan with a block.

    A graph with NO nodes has no endpoint for a self-loop: the empty graph
    stays unpadded.
    """
    e = edges.n_edges
    if e_pad <= e or edges.n_nodes == 0:
        return edges
    pad = e_pad - e
    z = np.zeros(pad, np.int32)
    return EdgeList(
        edges.n_nodes,
        np.concatenate([edges.src, z]),
        np.concatenate([edges.dst, z]),
        np.concatenate([edges.weight, np.ones(pad, np.int32)]),
    )


class SessionPool:
    """Bucketed sessions over many graphs on one device.

    ``open(edges)`` pads the edge arrays to a bucket multiple (inert
    self-loops) and resolves ``delta_init`` from the REAL edges first, so
    estimates equal an unpooled session's. ``estimate_many(graphs)`` groups
    the graphs by node count and pads each group to its largest edge
    count. All sessions share one ``SessionMetrics``, so the pool can
    answer "did any warm query rebuild a backend or re-upload edges?".
    ``rebuild_fraction`` is passed to every session it opens.
    """

    def __init__(self, cfg: Optional[GraphEngineConfig] = None,
                 edge_bucket: int = EDGE_BUCKET,
                 tau_solve: Optional[int] = None,
                 device="cuda",
                 rebuild_fraction: Optional[float] = None):
        if tau_solve is not None and tau_solve < 2:
            raise ValueError(f"tau_solve must be >= 2, got {tau_solve}")
        self.cfg = cfg or GraphEngineConfig()
        self.edge_bucket = edge_bucket
        self.tau_solve = tau_solve
        self.rebuild_fraction = rebuild_fraction
        self.device = resolve_device(device)
        self.metrics = SessionMetrics()
        self.sessions: List[GraphSession] = []
        self._closed = False

    def _check_open(self):
        if self._closed:
            raise RuntimeError("session pool is closed")

    def _make_session(self, edges: EdgeList, tau: Optional[int],
                      e_pad: Optional[int]) -> GraphSession:
        # both symbolic modes AND the config's own delta_init resolved over
        # the real weights, BEFORE padding (w = 1 loops would skew avg/min)
        stats = {"avg": _initial_delta(edges, "avg"),
                 "min": _initial_delta(edges, "min")}
        delta0 = stats.get(self.cfg.delta_init)
        if delta0 is None:
            delta0 = _initial_delta(edges, self.cfg.delta_init)
        gcfg = dataclasses.replace(self.cfg, delta_init=str(delta0))
        e_pad = e_pad or next_multiple(max(edges.n_edges, 1), self.edge_bucket)
        return GraphSession(_pad_edges(edges, e_pad), gcfg, tau=tau,
                            tau_solve=self.tau_solve, device=self.device,
                            metrics=self.metrics, delta_stats=stats,
                            rebuild_fraction=self.rebuild_fraction)

    def open(self, edges: EdgeList, *, tau: Optional[int] = None,
             e_pad: Optional[int] = None) -> GraphSession:
        """Open a RESIDENT session (tracked until ``pool.close()``)."""
        self._check_open()
        sess = self._make_session(edges, tau, e_pad)
        self.sessions.append(sess)
        return sess

    def estimate_many(self, graphs: Sequence[EdgeList], estimator=None,
                      tau: Optional[int] = None) -> List:
        """Open and query every graph, grouped by node count, each group
        padded to ONE bucketed edge size. Each session is closed right after
        its query and never registered with the pool, so the device holds
        one graph's buffers at a time; keep sessions resident with
        ``pool.open()`` to serve repeat queries."""
        self._check_open()
        if tau is not None and tau < 1:
            raise ValueError(f"tau must be >= 1, got {tau}")
        results: List = [None] * len(graphs)
        by_n: Dict[int, List[int]] = {}
        for i, g in enumerate(graphs):
            by_n.setdefault(g.n_nodes, []).append(i)
        for n, idxs in by_n.items():
            e_pad = next_multiple(
                max(graphs[i].n_edges for i in idxs) or 1, self.edge_bucket)
            group_tau = tau if tau is not None else tau_for(
                n, self.cfg.tau_fraction)
            for i in idxs:
                sess = self._make_session(graphs[i], group_tau, e_pad)
                try:
                    results[i] = sess.estimate(estimator)
                finally:
                    sess.close()
        return results

    def close(self):
        """Close every pooled session and retire the pool. Idempotent; a
        later ``open``/``estimate_many`` (or a query on a pooled session)
        raises ``RuntimeError``."""
        if self._closed:
            return
        for s in self.sessions:
            s.close()
        self.sessions.clear()
        self._closed = True

    def __enter__(self) -> "SessionPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""DEPRECATED one-shot entry points, thin wrappers over the session API
(``core/session.py`` + ``core/estimators.py``), as the JAX package keeps
them.

``approximate_diameter(edges, cfg)`` opens a throwaway ``GraphSession`` and
runs ``ClusterQuotientEstimator``, paying the full open cost (edge upload,
backend build) on every call. For repeated queries or many graphs use the
resident-graph API instead:

    from repro_torch.core import open_session, SessionPool
    sess = open_session(edges, cfg)          # upload + build ONCE
    est = sess.estimate()                    # paper pipeline
    with SessionPool(cfg) as pool:           # many graphs, padded buckets
        ests = pool.estimate_many(graphs)

Both wrappers emit ``DeprecationWarning`` and give the session path's
estimates field for field. ``PipelineMetrics`` / ``DiameterEstimate`` /
``tau_for`` / ``EDGE_BUCKET`` / ``SessionPool`` / ``_pad_edges`` are
re-exported, as the reference's module re-exports them.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

from repro_torch.common import GraphEngineConfig
from repro_torch.core.estimators import (  # noqa: F401  (re-exported)
    ClusterQuotientEstimator,
    DiameterEstimate,
    PipelineMetrics,
)
from repro_torch.core.session import (  # noqa: F401  (re-exported)
    EDGE_BUCKET,
    GraphSession,
    SessionPool,
    _pad_edges,
    tau_for,
)
from repro_torch.graph.structures import EdgeList

_DEPRECATION = (
    "{name}() is deprecated: it rebuilds the backend and re-uploads the edge "
    "arrays on every call. Use repro_torch.core.open_session(...) + a "
    "DiameterEstimator (or SessionPool for many graphs) instead."
)


def approximate_diameter(
    edges: EdgeList,
    cfg: Optional[GraphEngineConfig] = None,
    tau: Optional[int] = None,
    relax_fn=None,
    solver: str = "device",
    *,
    device="cuda",
) -> DiameterEstimate:
    """Deprecated one-shot paper pipeline. ``relax_fn`` (a RelaxBackend)
    overrides the backend selected by ``cfg.backend``; ``solver`` is
    ``"device"`` or ``"scipy"``."""
    warnings.warn(_DEPRECATION.format(name="approximate_diameter"),
                  DeprecationWarning, stacklevel=2)
    sess = GraphSession(edges, cfg, tau=tau, backend=relax_fn, device=device)
    return ClusterQuotientEstimator(solver=solver).estimate(sess)


def approximate_diameter_batch(
    graphs: Sequence[EdgeList],
    cfg: Optional[GraphEngineConfig] = None,
    tau: Optional[int] = None,
    *,
    device="cuda",
) -> List[DiameterEstimate]:
    """Deprecated batch entry point; delegates to ``SessionPool`` (grouped
    by node count, padded to the group's edge bucket, each graph's
    delta_init resolved from its real edges)."""
    warnings.warn(_DEPRECATION.format(name="approximate_diameter_batch"),
                  DeprecationWarning, stacklevel=2)
    with SessionPool(cfg, device=device) as pool:
        return pool.estimate_many(graphs, tau=tau)

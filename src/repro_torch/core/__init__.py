"""The decomposition engine, quotient pipeline, sessions and estimators."""
from repro_torch.core.backend import (
    KernelBackend,
    RelaxBackend,
    SingleDeviceBackend,
    make_backend,
)
from repro_torch.core.cluster import cluster
from repro_torch.core.engine import (
    Decomposition,
    EngineMetrics,
    default_uniform_fn,
    run_cluster,
)
from repro_torch.core.estimators import (
    ClusterQuotientEstimator,
    DiameterEstimate,
    DiameterInterval,
    IntervalEstimator,
    LowerBoundEstimator,
    PipelineMetrics,
)
from repro_torch.core.session import (
    GraphSession,
    SessionMetrics,
    open_session,
    tau_for,
)
from repro_torch.core.sssp import farthest_point_lower_bound

__all__ = [
    "ClusterQuotientEstimator", "Decomposition", "DiameterEstimate",
    "DiameterInterval", "EngineMetrics", "GraphSession", "IntervalEstimator",
    "KernelBackend", "LowerBoundEstimator", "PipelineMetrics", "RelaxBackend",
    "SessionMetrics", "SingleDeviceBackend", "cluster", "default_uniform_fn",
    "farthest_point_lower_bound", "make_backend",
    "open_session", "run_cluster", "tau_for",
]

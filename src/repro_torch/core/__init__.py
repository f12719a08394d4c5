"""The decomposition engine, quotient pipeline, sessions and estimators."""
from repro_torch.core.backend import (
    KernelBackend,
    RelaxBackend,
    SingleDeviceBackend,
    make_backend,
)
from repro_torch.core.cluster import cluster
from repro_torch.core.engine import (
    DECOMPOSITION_MODES,
    ENGINE_MODES,
    Decomposition,
    DecompositionMode,
    EngineMetrics,
    check_engine_mode,
    default_oneshot_uniform_fn,
    default_uniform_fn,
    resolve_engine_mode,
    run_cluster,
    run_oneshot,
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
    "ClusterQuotientEstimator", "DECOMPOSITION_MODES", "Decomposition",
    "DecompositionMode", "DiameterEstimate", "DiameterInterval",
    "ENGINE_MODES", "EngineMetrics", "GraphSession", "IntervalEstimator",
    "KernelBackend", "LowerBoundEstimator", "PipelineMetrics", "RelaxBackend",
    "SessionMetrics", "SingleDeviceBackend", "check_engine_mode", "cluster",
    "default_oneshot_uniform_fn", "default_uniform_fn", "farthest_point_lower_bound", "make_backend",
    "open_session", "resolve_engine_mode", "run_cluster", "run_oneshot",
    "tau_for",
]

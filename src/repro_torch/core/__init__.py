"""The decomposition engine, quotient pipeline, sessions and estimators."""
from repro_torch.core.backend import (
    KernelBackend,
    RelaxBackend,
    SingleDeviceBackend,
    make_backend,
)
from repro_torch.core.cluster import cluster, cluster2
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
    run_cluster2,
    run_oneshot,
)
from repro_torch.core.estimators import (
    CascadeEstimator,
    ClusterQuotientEstimator,
    DeltaSteppingEstimator,
    DiameterEstimate,
    DiameterEstimator,
    DiameterInterval,
    IntervalEstimator,
    LowerBoundEstimator,
    PipelineMetrics,
)
from repro_torch.core.session import (
    DEFAULT_TAU_SOLVE,
    GraphSession,
    SessionMetrics,
    open_session,
    tau_for,
)
from repro_torch.core.sssp import (
    bellman_ford,
    delta_stepping,
    diameter_2approx_sssp,
    farthest_point_lower_bound,
    multi_source_bellman_ford,
)

__all__ = [
    "CascadeEstimator", "ClusterQuotientEstimator", "DECOMPOSITION_MODES",
    "DEFAULT_TAU_SOLVE", "Decomposition", "DecompositionMode",
    "DeltaSteppingEstimator", "DiameterEstimate", "DiameterEstimator",
    "DiameterInterval", "ENGINE_MODES", "EngineMetrics", "GraphSession",
    "IntervalEstimator", "KernelBackend", "LowerBoundEstimator",
    "PipelineMetrics", "RelaxBackend", "SessionMetrics",
    "SingleDeviceBackend", "bellman_ford", "check_engine_mode", "cluster",
    "cluster2", "default_oneshot_uniform_fn", "default_uniform_fn",
    "delta_stepping", "diameter_2approx_sssp", "farthest_point_lower_bound",
    "make_backend", "multi_source_bellman_ford", "open_session",
    "resolve_engine_mode", "run_cluster", "run_cluster2", "run_oneshot",
    "tau_for",
]

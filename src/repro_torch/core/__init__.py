"""The decomposition engine, quotient pipeline, sessions and estimators."""
from repro_torch.core.autotune import (
    TUNE_EVENTS,
    AutotuneError,
    GraphStats,
    TuningRecord,
    clear_cache,
    compute_graph_stats,
    derive_tuning,
    get_tuning,
    graph_signature,
    load_cache,
    save_cache,
    validate_tuning,
)
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
    DynamicQuotientEstimator,
    IntervalEstimator,
    LowerBoundEstimator,
    PipelineMetrics,
)
from repro_torch.core.dynamic import (
    DynamicMetrics,
    DynamicState,
    UpdateBatch,
    UpdateReport,
)
from repro_torch.core.session import (
    DEFAULT_REBUILD_FRACTION,
    DEFAULT_TAU_SOLVE,
    EDGE_BUCKET,
    GraphSession,
    SessionMetrics,
    SessionPool,
    open_session,
    tau_for,
)
from repro_torch.core.diameter import (
    approximate_diameter,
    approximate_diameter_batch,
)
from repro_torch.core.sssp import (
    bellman_ford,
    delta_stepping,
    diameter_2approx_sssp,
    farthest_point_lower_bound,
    multi_source_bellman_ford,
)

__all__ = [
    "AutotuneError", "CascadeEstimator", "ClusterQuotientEstimator",
    "DECOMPOSITION_MODES", "DEFAULT_REBUILD_FRACTION", "DEFAULT_TAU_SOLVE",
    "Decomposition", "DecompositionMode", "DeltaSteppingEstimator",
    "DiameterEstimate", "DiameterEstimator", "DiameterInterval",
    "DynamicMetrics", "DynamicQuotientEstimator", "DynamicState",
    "EDGE_BUCKET", "ENGINE_MODES",
    "EngineMetrics", "GraphSession", "GraphStats", "IntervalEstimator",
    "KernelBackend", "LowerBoundEstimator", "PipelineMetrics",
    "RelaxBackend", "SessionMetrics", "SessionPool", "SingleDeviceBackend",
    "TUNE_EVENTS", "TuningRecord", "UpdateBatch", "UpdateReport",
    "approximate_diameter",
    "approximate_diameter_batch", "bellman_ford", "check_engine_mode",
    "clear_cache", "cluster", "cluster2", "compute_graph_stats",
    "default_oneshot_uniform_fn", "default_uniform_fn", "delta_stepping",
    "derive_tuning", "diameter_2approx_sssp", "farthest_point_lower_bound",
    "get_tuning", "graph_signature", "load_cache", "make_backend",
    "multi_source_bellman_ford", "open_session", "resolve_engine_mode",
    "run_cluster", "run_cluster2", "run_oneshot", "save_cache", "tau_for",
    "validate_tuning",
]

"""Host graph layer: edge lists, seeded generators (an update trace among
them), segment tuple-min, node partitions, and the edge stores (the
mutable ``EdgeStore`` and the partition-aware ``GraphStore``)."""
from repro_torch.graph.generators import (
    assign_weights,
    grid_mesh,
    random_geometric,
    rmat,
    road_like,
    social_like,
    temporal_trace,
)
from repro_torch.graph.segment_ops import (
    segment_min,
    segment_min_pair,
    segment_min_triple,
)
from repro_torch.graph.partition import (
    apply_partition,
    cluster_partition,
    cut_fraction,
    partition_for_backend,
    range_partition,
)
from repro_torch.graph.storage import (
    EDGE_STORE_BUCKET,
    EdgeSlab,
    EdgeStore,
    GraphStore,
)
from repro_torch.graph.structures import (
    MAX_WEIGHT,
    EdgeList,
    rescale_weights,
    to_scipy_csr,
    weight_scale_for,
)

__all__ = [
    "EDGE_STORE_BUCKET", "EdgeList", "EdgeSlab", "EdgeStore", "GraphStore",
    "MAX_WEIGHT", "apply_partition", "assign_weights", "cluster_partition",
    "cut_fraction", "grid_mesh", "partition_for_backend",
    "random_geometric", "range_partition", "rescale_weights", "rmat",
    "road_like", "segment_min", "segment_min_pair", "segment_min_triple",
    "social_like", "temporal_trace", "to_scipy_csr", "weight_scale_for",
]

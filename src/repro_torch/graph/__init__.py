"""Host graph layer: edge lists, seeded generators (an update trace among
them), segment tuple-min, and the mutable edge store of dynamic graphs."""
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
from repro_torch.graph.storage import EDGE_STORE_BUCKET, EdgeStore
from repro_torch.graph.structures import (
    MAX_WEIGHT,
    EdgeList,
    rescale_weights,
    to_scipy_csr,
    weight_scale_for,
)

__all__ = [
    "EDGE_STORE_BUCKET", "EdgeList", "EdgeStore", "MAX_WEIGHT",
    "assign_weights", "grid_mesh", "random_geometric", "rescale_weights",
    "rmat", "road_like", "segment_min", "segment_min_pair",
    "segment_min_triple", "social_like", "temporal_trace", "to_scipy_csr",
    "weight_scale_for",
]

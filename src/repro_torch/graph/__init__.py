"""Host graph layer: edge lists, seeded generators, segment tuple-min."""
from repro_torch.graph.generators import (
    assign_weights,
    grid_mesh,
    random_geometric,
    rmat,
    road_like,
    social_like,
)
from repro_torch.graph.segment_ops import (
    segment_min,
    segment_min_pair,
    segment_min_triple,
)
from repro_torch.graph.structures import (
    MAX_WEIGHT,
    EdgeList,
    rescale_weights,
    to_scipy_csr,
    weight_scale_for,
)

__all__ = [
    "EdgeList", "MAX_WEIGHT", "assign_weights", "grid_mesh",
    "random_geometric", "rescale_weights", "rmat", "road_like",
    "segment_min", "segment_min_pair", "segment_min_triple", "social_like",
    "to_scipy_csr", "weight_scale_for",
]

"""Architecture configs of the port: ``ArchConfig``, ``TransformerConfig``,
``GNNConfig``, ``RecsysConfig``, ``GraphEngineConfig``, ``ShapeSpec`` with
the GNN and recsys shape sets, and the registry of ported arches."""
from repro_torch.config.base import (GNN_SHAPES, RECSYS_SHAPES, ArchConfig,
                                     GNNConfig, GraphEngineConfig,
                                     RecsysConfig, ShapeSpec,
                                     TransformerConfig)
from repro_torch.config.registry import get_arch, list_archs, register_arch

__all__ = ["ArchConfig", "GNNConfig", "GNN_SHAPES", "GraphEngineConfig",
           "RECSYS_SHAPES", "RecsysConfig", "ShapeSpec", "TransformerConfig",
           "get_arch", "list_archs", "register_arch"]

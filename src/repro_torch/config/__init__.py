"""Architecture configs of the port: ``ArchConfig``, ``TransformerConfig``,
``MoEConfig``, ``GNNConfig``, ``RecsysConfig``, ``GraphEngineConfig``,
``TrainConfig``, ``ShapeSpec`` with the LM, GNN and recsys shape sets, and the registry of
ported arches."""
from repro_torch.config.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                     ArchConfig, GNNConfig,
                                     GraphEngineConfig, MoEConfig,
                                     RecsysConfig, ShapeSpec, TrainConfig,
                                     TransformerConfig, shapes_for_family)
from repro_torch.config.registry import get_arch, list_archs, register_arch

__all__ = ["ArchConfig", "GNNConfig", "GNN_SHAPES", "GraphEngineConfig",
           "LM_SHAPES", "MoEConfig", "RECSYS_SHAPES", "RecsysConfig",
           "ShapeSpec", "TrainConfig", "TransformerConfig", "get_arch", "list_archs",
           "register_arch", "shapes_for_family"]

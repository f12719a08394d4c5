"""Architecture configs of the port: ``ArchConfig``, ``TransformerConfig``,
``RecsysConfig``, ``ShapeSpec`` with the recsys shape set, and the
registry of ported arches."""
from repro_torch.config.base import (RECSYS_SHAPES, ArchConfig, RecsysConfig,
                                     ShapeSpec, TransformerConfig)
from repro_torch.config.registry import get_arch, list_archs, register_arch

__all__ = ["ArchConfig", "RECSYS_SHAPES", "RecsysConfig", "ShapeSpec",
           "TransformerConfig", "get_arch", "list_archs", "register_arch"]

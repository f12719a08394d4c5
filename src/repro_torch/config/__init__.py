"""Architecture configs of the port (the LM slice): ``ArchConfig``,
``TransformerConfig`` and the registry of ported arches."""
from repro_torch.config.base import ArchConfig, TransformerConfig
from repro_torch.config.registry import get_arch, list_archs, register_arch

__all__ = ["ArchConfig", "TransformerConfig", "get_arch", "list_archs",
           "register_arch"]

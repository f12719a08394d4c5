"""Architecture registry of the port: maps ``--arch`` ids to config
factories, over the arches the port has ported. Factories are lazy, so
importing the registry builds no config.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

from repro_torch.config.base import ArchConfig

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}

# arch-id -> module under repro_torch.configs that registers it (the ported
# arches only; the reference registers more)
_ARCH_MODULES = {
    "gcn-cora": "gcn_cora",
    "gemma2-9b": "gemma2_9b",
    "xdeepfm": "xdeepfm",
}


def register_arch(name: str, factory: Callable[[], ArchConfig],
                  smoke: Callable[[], ArchConfig]) -> None:
    _REGISTRY[name] = factory
    _SMOKE_REGISTRY[name] = smoke


def _ensure_loaded(name: str) -> None:
    if name in _REGISTRY:
        return
    mod = _ARCH_MODULES.get(name)
    if mod is None:
        raise KeyError(f"arch {name!r} is not ported; ported arches: "
                       f"{sorted(_ARCH_MODULES)}")
    importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    _ensure_loaded(name)
    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    return reg[name]()


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(_ARCH_MODULES))

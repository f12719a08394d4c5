"""Architecture registry of the port: maps ``--arch`` ids to config
factories, over the eleven arches the reference registers. Factories are
lazy, so importing the registry builds no config.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

from repro_torch.config.base import ArchConfig

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}

# arch-id -> module under repro_torch.configs that registers it (the
# reference's eleven arches)
_ARCH_MODULES = {
    "equiformer-v2": "equiformer_v2",
    "gatedgcn": "gatedgcn",
    "gcn-cora": "gcn_cora",
    "gemma2-9b": "gemma2_9b",
    "meshgraphnet": "meshgraphnet",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "mixtral-8x7b": "mixtral_8x7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "paper-graph": "paper_graph",
    "qwen1.5-32b": "qwen1_5_32b",
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
        raise KeyError(f"arch {name!r} is not registered; arches: "
                       f"{sorted(_ARCH_MODULES)}")
    importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    _ensure_loaded(name)
    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    return reg[name]()


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(_ARCH_MODULES))

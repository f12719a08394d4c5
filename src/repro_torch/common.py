"""Small shared utilities and the engine config.

``next_multiple``, ``get_logger`` and ``Timer`` are copies of the JAX
package's ``common/util.py`` helpers; ``GraphEngineConfig`` is
``config/base.py``'s, re-exported here. ``resolve_device`` is the port's
one device policy: CUDA unless the caller asks for the CPU, and an error
(never a silent CPU run) when CUDA is asked for and absent.
``tree_leaves`` and ``tree_map`` walk the port's parameter trees (nested
dicts and lists of tensors) in the JAX package's leaf order (dict keys
sorted).
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Callable, List, Optional, Union

import torch

from repro_torch.config.base import GraphEngineConfig
from repro_torch.runtime.telemetry import clock

__all__ = ["GraphEngineConfig", "Timer", "ceil_div", "get_logger",
           "next_multiple", "resolve_device", "to_device", "tree_leaves",
           "tree_map"]


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (and >= m)."""
    return max(m, ceil_div(x, m) * m)


class Timer:
    """Context-manager wall timer. ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self) -> "Timer":
        self._t0 = clock()
        self.seconds = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = clock() - self._t0


_LOGGERS: dict = {}


def get_logger(name: str = "repro_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is requested but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(a, device: Union[str, torch.device],
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` (a numpy array, a host tensor or a device tensor), cast to
    ``dtype`` if given, as a new tensor on ``device``.

    A host array reaches the card through pinned memory, copied
    asynchronously on the current stream: a copy from pageable memory
    makes the host wait for the card's queue to drain, which is a
    synchronisation that ``guard.measured_transfers("disallow")`` refuses.
    Otherwise the result is a copy, so it never aliases ``a``."""
    t = torch.as_tensor(a, dtype=dtype)
    dev = torch.device(device)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev, copy=True)

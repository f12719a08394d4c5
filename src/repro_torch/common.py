"""Small shared utilities and the engine config.

``next_multiple``, ``get_logger`` and ``Timer`` are copies of the JAX
package's ``common/util.py`` helpers; ``GraphEngineConfig`` keeps the
fields of ``config/base.py::GraphEngineConfig`` that the staged pipeline
reads. ``resolve_device`` is the port's one device policy: CUDA unless the
caller asks for the CPU, and an error (never a silent CPU run) when CUDA
is asked for and absent.
"""
from __future__ import annotations

import logging
import sys
from dataclasses import dataclass
from typing import Union

import torch

from repro_torch.runtime.telemetry import clock


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


@dataclass(frozen=True)
class GraphEngineConfig:
    """Config for the decomposition/diameter engine."""

    tau_fraction: float = 1e-3   # tau ~ n * tau_fraction / log n
    gamma: float = 2.0           # center-sampling constant
    variant: str = "stop"        # stop | complete (paper Table 2)
    delta_init: str = "avg"      # avg | min | <int>
    max_stages: int = 64
    max_steps_per_phase: int = 0  # 0 -> 2n/tau (paper's num_it)
    seed: int = 0
    backend: str = "kernel"      # single | kernel (core/backend.py)
    fuse_supersteps: int = 0     # kernel backend: supersteps per megakernel
                                 # launch (0 = unfused)
    mode: str = "stages"         # stages | oneshot | auto (core/engine.py;
                                 # "auto" resolves to "stages": no autotuner)
    deterministic: bool = False  # oneshot: hash-derived centers and shifts

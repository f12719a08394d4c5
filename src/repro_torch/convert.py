"""Carry graph and engine state over from the JAX package.

This system has no model weights: its carried state is the graph and the
engine planes. ``from_reference`` turns the JAX package's ``EdgeList``
arrays and ``EngineState`` planes, given as numpy, into the port's
``EdgeList`` and ``EngineState`` on a device, so both packages can start
from the same mid-decomposition state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.state import EngineState
from repro_torch.graph.structures import EdgeList

PLANE_NAMES = tuple(f.name for f in dataclasses.fields(EngineState))
_BOOL_PLANES = ("covered", "is_center")


def from_reference(edges_np: Any, planes_np: Any = None,
                   device="cuda") -> Tuple[EdgeList, Optional[EngineState]]:
    """``edges_np``: the reference ``EdgeList`` (any object with
    ``n_nodes``, ``src``, ``dst``, ``weight``). ``planes_np``: the eight
    ``EngineState`` planes as numpy, by name (a mapping or the reference
    ``EngineState``'s ``_asdict()``), or None. Returns the port's
    ``(EdgeList, EngineState or None)``; planes land on ``device``."""
    edges = EdgeList(int(edges_np.n_nodes), np.asarray(edges_np.src),
                     np.asarray(edges_np.dst), np.asarray(edges_np.weight))
    if planes_np is None:
        return edges, None
    if hasattr(planes_np, "_asdict"):
        planes_np = planes_np._asdict()
    dev = resolve_device(device)
    tensors = {}
    for name in PLANE_NAMES:
        dtype = torch.bool if name in _BOOL_PLANES else torch.int32
        tensors[name] = torch.tensor(np.asarray(planes_np[name]), dtype=dtype,
                                     device=dev)
    return edges, EngineState(**tensors)

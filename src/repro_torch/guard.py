"""The one device->host seam of the port.

Every host read on the pipeline path goes through :func:`fetch`, which does
the ``.cpu()`` copy and counts the call in every active
:class:`TransferMeter`. The engine and estimator sync counters are
hand-incremented next to each ``fetch``; a test wraps a query in
:func:`metered` and asserts the two agree.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterator, List

import numpy as np
import torch


@dataclass
class TransferMeter:
    """Counts sanctioned fetches inside a :func:`metered` region."""

    transfers: int = 0
    reason_counts: Counter = field(default_factory=Counter)


# a stack: harnesses nest (a region around an estimator that itself opens
# one around the engine)
_METERS: List[TransferMeter] = []


def fetch(x: torch.Tensor, reason: str) -> np.ndarray:
    """Copy ``x`` to the host as numpy and count the transfer."""
    if not reason:
        raise ValueError("guard.fetch needs a non-empty reason")
    out = x.detach().cpu().numpy()
    for m in _METERS:
        m.transfers += 1
        m.reason_counts[reason] += 1
    return out


@contextlib.contextmanager
def metered() -> Iterator[TransferMeter]:
    """Count every :func:`fetch` made inside the ``with`` block."""
    meter = TransferMeter()
    _METERS.append(meter)
    try:
        yield meter
    finally:
        _METERS.remove(meter)

"""The one sanctioned clock seam of the port.

Every duration in ``repro_torch`` (``common.Timer``, the launcher, the smoke
script's host timings) reads time through :func:`clock`, so the determinism
lint can flag stray wall-clock reads inside the decomposition modules.
"""
from __future__ import annotations

import time


def clock() -> float:
    """Monotonic seconds (``time.perf_counter``)."""
    return time.perf_counter()

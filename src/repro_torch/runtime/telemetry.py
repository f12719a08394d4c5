"""The sanctioned clock seams of the port.

Every duration in ``repro_torch`` (``common.Timer``, the launcher, the smoke
script's host timings) reads time through :func:`clock`, and a checkpoint
stamps its writing time through :func:`wall_time`, so the determinism
lint can flag stray wall-clock reads inside the decomposition modules.
"""
from __future__ import annotations

import time


def clock() -> float:
    """Monotonic seconds (``time.perf_counter``)."""
    return time.perf_counter()


def wall_time() -> float:
    """Epoch seconds, for provenance only (a checkpoint's ``written_at``);
    never read back into a computed result."""
    return time.time()

"""The one device->host seam of the port, and the regions that meter it.

Every host read on the pipeline path goes through :func:`fetch`, which
does the ``.cpu()`` copy, records the caller's ``reason`` (the runtime
twin of the ``# sync:`` pragma of ``repro_torch.analysis``) and counts the
call and its elements in every active :class:`TransferMeter`. The engine
and estimator sync counters are hand-incremented next to each ``fetch``,
and a region proves the two agree:

  measured == EngineMetrics.host_syncs + finalize_syncs   (decomposition)
  measured == PipelineMetrics.total_host_syncs            (pipeline query)
  measured == DynamicMetrics.update_syncs delta           (update batch)

:func:`measured_transfers` meters a region and, on the card, also forbids
the reads that bypass ``fetch``: it maps its level onto
``torch.cuda.set_sync_debug_mode`` (``"disallow"`` -> ``"error"``,
``"log"`` -> ``"warn"``, ``"allow"`` -> ``"default"``), so an implicit
synchronisation inside the region (a ``.item()``, a boolean-mask index, a
blocking copy) raises, and ``fetch`` lifts the mode around its own copy.
Where CUDA is absent the region only counts: ``set_sync_debug_mode``
raises on a torch built without CUDA, and CPU tensors are host memory, so
there is nothing to forbid. The JAX reference behaves the same way: its
transfer guard never fires on the CPU backend, and its static sync-lint
is the enforcement layer there, as ``repro_torch.analysis`` is here. The
guard sees only the synchronisations PyTorch itself makes; a copy inside
a kernel library's own C++ wrapper is invisible to it, and the equality of
measured and counted reads stays the check for those.

:func:`push_meter` / :func:`pop_meter` are the meter-only half, with no
effect on the card's mode: the telemetry spans attribute reads with them
(one list append each, no synchronisation).

The module lives at ``repro_torch/guard.py`` rather than under
``analysis/`` as the reference's does: the port's fetch sites (engine,
estimators, quotient, sssp, dynamic, checkpoint, kernels) import it from
here. It imports torch only inside the functions that touch the card's
mode, so ``runtime/telemetry.py``, which pushes and pops its meters,
loads no torch.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# measured_transfers' levels, as the reference's transfer guard names
# them, and the sync debug mode each one sets on the card
SYNC_MODES = {"disallow": "error", "log": "warn", "allow": "default"}
# torch.cuda.get_sync_debug_mode()'s number for each mode
_MODE_NUMBERS = {"default": 0, "warn": 1, "error": 2}


@dataclass
class TransferMeter:
    """Counts sanctioned fetches inside a metered region.

    Per-reason accounting is aggregated (one ``Counter`` entry per
    distinct reason), so a meter's memory is bounded by the number of
    fetch sites, not by the number of fetches."""

    transfers: int = 0
    elements: int = 0
    reason_counts: Counter = field(default_factory=Counter)
    reason_elements: Counter = field(default_factory=Counter)

    def reasons(self) -> List[str]:
        """Distinct fetch reasons seen in this region, first-seen order."""
        return list(self.reason_counts)

    def by_reason(self) -> Dict[str, Tuple[int, int]]:
        """reason -> (fetch count, total elements fetched)."""
        return {r: (int(c), int(self.reason_elements[r]))
                for r, c in self.reason_counts.items()}


# a stack: harnesses nest (a region around an estimator that itself opens
# one around the engine; a span inside a measured region)
_METERS: List[TransferMeter] = []


def active_meter() -> Optional[TransferMeter]:
    return _METERS[-1] if _METERS else None


def push_meter() -> TransferMeter:
    """Push a meter-only region: counts sanctioned fetches without touching
    the card's sync debug mode. ``fetch`` counts in every meter on the
    stack, so it composes with any ambient region."""
    meter = TransferMeter()
    _METERS.append(meter)
    return meter


def pop_meter(meter: TransferMeter) -> TransferMeter:
    # validate before popping: a mismatched pop must not take someone
    # else's meter with it on its way to raising
    if not _METERS or _METERS[-1] is not meter:
        raise RuntimeError("guard meter stack corrupted: non-LIFO pop")
    return _METERS.pop()


@contextlib.contextmanager
def metered() -> Iterator[TransferMeter]:
    """Count every :func:`fetch` made inside the ``with`` block."""
    meter = push_meter()
    try:
        yield meter
    finally:
        pop_meter(meter)


@contextlib.contextmanager
def _sync_debug_mode(mode: str) -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, the previous
    mode restored on exit (also on an exception); nothing without CUDA."""
    import torch

    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    if prev == _MODE_NUMBERS[mode]:   # already so (a fetch outside a region)
        yield
        return
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def measured_transfers(level: str = "disallow") -> Iterator[TransferMeter]:
    """Meter the sanctioned fetches of the enclosed region and, on the
    card, forbid unsanctioned synchronisations at ``level`` ("disallow" |
    "log" | "allow")."""
    if level not in SYNC_MODES:
        raise ValueError(f"measured_transfers: level must be one of "
                         f"{sorted(SYNC_MODES)}, got {level!r}")
    meter = push_meter()
    try:
        with _sync_debug_mode(SYNC_MODES[level]):
            yield meter
    finally:
        pop_meter(meter)


def fetch(x: "torch.Tensor", reason: str) -> np.ndarray:
    """The sanctioned device->host read: ``x`` as numpy, counted in every
    active meter. ``reason`` is mandatory and non-empty; it shows up in
    ``TransferMeter.by_reason()``."""
    if not reason or not reason.strip():
        raise ValueError("guard.fetch needs a non-empty reason")
    with _sync_debug_mode("default"):
        out = x.detach().cpu().numpy()  # sync: the sanctioned read itself
    size = int(out.size)
    for m in _METERS:
        m.transfers += 1
        m.elements += size
        m.reason_counts[reason] += 1
        m.reason_elements[reason] += size
    return out

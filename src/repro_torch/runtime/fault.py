"""Fault tolerance, the port of the JAX package's ``runtime/fault.py``:
preemption handling, retries and straggler detection.

  * ``PreemptionGuard`` — SIGTERM/SIGINT set a flag; the stage loop
    checkpoints and raises ``Preempted`` at the next stage boundary.
    Leaving the guard puts back the handlers it replaced.
  * ``retriable()`` — a retry wrapper with a doubling backoff for
    transient filesystem or device errors.
  * ``StragglerMonitor`` — per-step wall-time EWMA; a step slower than
    ``threshold`` x the EWMA is flagged and logged.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.common import get_logger

log = get_logger("repro_torch.fault")


class Preempted(Exception):
    """A decomposition was preempted at a stage boundary AFTER its
    checkpoint was durably written.

    Raised by ``core.engine.StageCheckpointer`` when a ``PreemptionGuard``
    saw SIGTERM / SIGINT: the stage finishes, its state is saved, and then
    this fires, so a launcher that exits with :data:`EXIT_PREEMPTED` can be
    rerun with ``--resume`` to finish from that boundary.

    A direct ``Exception`` subclass, not a ``RuntimeError``:
    :func:`retriable` retries ``RuntimeError`` by default, and a preemption
    is never retried in place.
    """

    def __init__(self, stage: int, path: Optional[str],
                 signum: Optional[int] = None):
        super().__init__(
            f"preempted at stage boundary {stage}; checkpoint at {path}")
        self.stage = stage
        self.path = path
        self.signum = signum


# BSD EX_TEMPFAIL: the "run me again" exit status the launchers return
# after a clean preemption checkpoint
EXIT_PREEMPTED = 75


class PreemptionGuard:
    """SIGTERM-aware context: ``guard.should_stop`` flips on preemption."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._prev = {}
        self.should_stop = False
        self.received: Optional[int] = None

    def _handler(self, signum, frame):
        self.should_stop = True
        self.received = signum
        log.warning("preemption signal %s received; will checkpoint and "
                    "exit", signum)

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)


def retriable(fn: Callable, retries: int = 3, base_delay: float = 0.1,
              exceptions=(OSError, IOError, RuntimeError)):
    """Retry ``fn`` up to ``retries`` times on ``exceptions``, sleeping
    ``base_delay``, then twice that, and so on, between attempts."""

    def wrapped(*args, **kwargs):
        delay = base_delay
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except exceptions as e:
                if attempt == retries:
                    raise
                log.warning("attempt %d failed (%s); retrying in %.2fs",
                            attempt + 1, e, delay)
                time.sleep(delay)
                delay *= 2

    return wrapped


@dataclass
class StragglerMonitor:
    """EWMA step timing; flags outlier steps."""

    threshold: float = 2.0
    alpha: float = 0.1
    ewma: float = 0.0
    n: int = 0
    flagged: List[int] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        slow = self.n >= 3 and seconds > self.threshold * self.ewma
        if slow:
            self.flagged.append(step)
            log.warning("straggler: step %d took %.3fs (%.1fx EWMA %.3fs)",
                        step, seconds, seconds / max(self.ewma, 1e-9),
                        self.ewma)
        self.ewma = seconds if self.n == 0 else (
            (1 - self.alpha) * self.ewma + self.alpha * seconds)
        self.n += 1
        return slow

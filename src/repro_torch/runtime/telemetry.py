"""Telemetry of the port, the JAX package's ``runtime/telemetry.py``:
nestable span tracing with per-span transfer attribution, a metrics
registry, and Perfetto/JSONL/Prometheus exporters.

  * :func:`span` opens a nestable phase span (``engine.stage``,
    ``quotient.solve``, ``dynamic.relax``, ...). On close each span
    carries the counters set on it (supersteps, kernel_launches, ...) and
    its **per-reason transfer attribution**: a ``guard`` meter is pushed
    for the span's lifetime, and the exclusive share (its own fetches
    minus its descendants') labels every measured read with the span that
    made it.
  * :class:`MetricsRegistry` folds ``EngineMetrics`` / ``PipelineMetrics``
    / ``SessionMetrics`` / ``DynamicMetrics`` / ``TransferMeter`` into one
    :class:`TelemetrySnapshot` of counters, gauges and streaming
    histograms (p50/p95/p99).
  * :func:`export_chrome_trace` / :func:`export_jsonl` /
    :func:`export_prometheus` write the three consumer formats;
    :func:`write_telemetry` is the launchers' one call.

Contracts:

  * **No synchronisation.** This module imports no torch. Span
    attribution uses ``guard.push_meter``/``pop_meter`` (list operations),
    and a span never waits for the card: its duration is host time under
    asynchronous launch, as the reference's is under JAX's asynchronous
    dispatch. The measured/counted read equalities hold with tracing on.
  * **Near-zero cost when off.** With no tracer installed, ``span()``
    returns a shared no-op singleton: no allocation on hot paths.
  * **One clock seam.** :func:`clock` / :func:`wall_time` are the only
    sanctioned time reads in ``repro_torch`` (``common.Timer``, the
    launchers, a checkpoint's ``written_at``): the determinism lint flags
    bare ``time.*`` calls everywhere else.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from collections import Counter
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Iterator, List, Optional

from repro_torch import guard


def clock() -> float:
    """Monotonic seconds (``time.perf_counter``)."""
    return time.perf_counter()


def wall_time() -> float:
    """Epoch seconds, for provenance only (a checkpoint's ``written_at``);
    never read back into a computed result."""
    return time.time()


# --------------------------------------------------------------------------
# Span tracer
# --------------------------------------------------------------------------


@dataclass
class SpanRecord:
    """A closed span. ``transfers``/``elements``/``by_reason`` are the
    span's *exclusive* share (own fetches minus descendants'), so summing
    them over any trace equals the total measured transfers exactly."""

    name: str
    start: float                     # seconds from tracer epoch
    duration: float
    depth: int
    index: int                       # start order, unique within a trace
    parent: Optional[int]            # parent span's index
    attrs: Dict[str, Any] = field(default_factory=dict)
    transfers: int = 0               # exclusive fetch count
    elements: int = 0                # exclusive fetched elements
    transfers_incl: int = 0          # inclusive (self + descendants)
    by_reason: Dict[str, int] = field(default_factory=dict)


class Span:
    """A live span: context manager pushed by ``Tracer.span``. ``set()``
    attaches attributes (supersteps, kernel_launches, ...) any time
    before close."""

    __slots__ = ("_tracer", "name", "attrs", "index", "depth", "_parent",
                 "_t0", "_meter", "_child_transfers", "_child_elements",
                 "_child_reasons")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 index: int, depth: int, parent: Optional[int]):
        self._tracer = tracer
        self.name = name
        self.attrs = dict(attrs)
        self.index = index
        self.depth = depth
        self._parent = parent
        self._child_transfers = 0
        self._child_elements = 0
        self._child_reasons: Counter = Counter()

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = clock()
        self._meter = guard.push_meter()
        return self

    def __exit__(self, *exc: Any) -> None:
        end = clock()
        tracer = self._tracer
        # validate BEFORE popping the guard meter so an out-of-order close
        # raises without corrupting the meter stack
        if not tracer._live or tracer._live[-1] is not self:
            raise RuntimeError("span stack corrupted: non-LIFO close")
        meter = guard.pop_meter(self._meter)
        tracer._live.pop()
        excl_reasons = meter.reason_counts - self._child_reasons
        record = SpanRecord(
            name=self.name,
            start=self._t0 - tracer.epoch,
            duration=end - self._t0,
            depth=self.depth,
            index=self.index,
            parent=self._parent,
            attrs=self.attrs,
            transfers=meter.transfers - self._child_transfers,
            elements=meter.elements - self._child_elements,
            transfers_incl=meter.transfers,
            by_reason={r: int(c) for r, c in excl_reasons.items() if c},
        )
        tracer.spans.append(record)
        if tracer._live:
            parent = tracer._live[-1]
            parent._child_transfers += meter.transfers
            parent._child_elements += meter.elements
            parent._child_reasons += meter.reason_counts


class _NullSpan:
    """Shared no-op span: returned when no tracer is installed so hot
    paths pay one truthiness check and no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects closed :class:`SpanRecord`\\ s for one traced region."""

    def __init__(self) -> None:
        self.epoch = clock()
        self.spans: List[SpanRecord] = []
        self._live: List[Span] = []
        self._next_index = 0

    def span(self, name: str, **attrs: Any) -> Span:
        parent = self._live[-1].index if self._live else None
        s = Span(self, name, attrs, self._next_index,
                 depth=len(self._live), parent=parent)
        self._next_index += 1
        self._live.append(s)
        return s

    # -- trace-level queries -------------------------------------------

    def total_transfers(self) -> int:
        """Sum of exclusive transfer counts == total fetches measured
        under any root span (exclusive counts partition the total)."""
        return sum(s.transfers for s in self.spans)

    def attribution(self) -> Dict[str, Dict[str, int]]:
        """span name -> {reason: exclusive fetch count}, aggregated over
        all spans with that name. Fetches outside any span don't appear
        here — wrap the region in a root span for exactness."""
        out: Dict[str, Counter] = {}
        for s in self.spans:
            if s.transfers:
                out.setdefault(s.name, Counter()).update(s.by_reason)
        return {name: dict(c) for name, c in out.items()}


# Stack, not a slot: a serve harness traces the whole replay while a
# bench traces one query inside it.
_TRACERS: List[Tracer] = []


def active_tracer() -> Optional[Tracer]:
    return _TRACERS[-1] if _TRACERS else None


def span(name: str, **attrs: Any):
    """Open a span on the active tracer, or a shared no-op when tracing
    is off. Usage: ``with telemetry.span("engine.stage", stage=i) as sp:
    ...; sp.set(supersteps=k)``."""
    if not _TRACERS:
        return NULL_SPAN
    return _TRACERS[-1].span(name, **attrs)


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Install a tracer for the enclosed region."""
    t = tracer if tracer is not None else Tracer()
    _TRACERS.append(t)
    try:
        yield t
    finally:
        popped = _TRACERS.pop()
        if popped is not t:
            raise RuntimeError("tracer stack corrupted: non-LIFO pop")


# --------------------------------------------------------------------------
# Streaming histogram
# --------------------------------------------------------------------------

_HIST_GROWTH = 1.08
_HIST_LOG_GROWTH = math.log(_HIST_GROWTH)
_HIST_TINY = 1e-12


class StreamingHistogram:
    """Log-bucketed streaming histogram: O(distinct magnitudes) memory,
    exact-associative merge, quantiles within a ``GROWTH`` relative
    factor (~4% at 1.08) of the true order statistic.

    Values are nonnegative (latencies, counts); values below ``1e-12``
    (including 0) share one underflow bucket. ``quantile`` clamps to the
    exact observed ``[min, max]``, so constant data is quantile-exact.
    """

    __slots__ = ("count", "total", "min", "max", "_buckets", "_zero")

    GROWTH = _HIST_GROWTH

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._zero = 0

    def record(self, value: float) -> None:
        v = float(value)
        if v < 0.0 or math.isnan(v):
            raise ValueError(f"histogram values must be >= 0, got {value}")
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < _HIST_TINY:
            self._zero += 1
        else:
            idx = int(math.floor(math.log(v) / _HIST_LOG_GROWTH))
            self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold ``other`` into self. Bucket-count addition — associative
        and commutative exactly, so shard-then-merge equals streaming."""
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self._zero += other._zero
        for idx, c in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + c
        return self

    def quantile(self, q: float) -> float:
        """Approximate ``q``-quantile (q in [0, 1]). Empty -> 0.0."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        if q >= 1.0:
            return self.max    # the extremes are tracked exactly
        if q <= 0.0:
            return self.min
        # rank in [1, count]; walk buckets in value order
        rank = max(1, int(math.ceil(q * self.count)))
        if rank <= self._zero:
            return max(0.0, self.min)
        seen = self._zero
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                # geometric midpoint of the bucket, clamped to observed range
                mid = math.exp((idx + 0.5) * _HIST_LOG_GROWTH)
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


# --------------------------------------------------------------------------
# Metrics registry
# --------------------------------------------------------------------------


@dataclass
class TelemetrySnapshot:
    """One frozen view of everything the registry knows: monotonic
    counters, point-in-time gauges, and histogram summaries."""

    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    histograms: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: dict(v) for k, v in self.histograms.items()}}


class MetricsRegistry:
    """Unifies the repo's per-subsystem metrics dataclasses into one
    namespace. ``ingest`` folds any metrics dataclass's numeric fields in
    as ``<prefix>.<field>`` counters; ``TransferMeter`` additionally
    contributes per-reason ``<prefix>.reason.<reason>`` counters."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, StreamingHistogram] = {}

    def counter(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def histogram(self, name: str) -> StreamingHistogram:
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = StreamingHistogram()
        return hist

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).record(value)

    def ingest(self, metrics: Any, prefix: str) -> None:
        """Fold a metrics object in. Accepts the repo's dataclasses
        (EngineMetrics, PipelineMetrics, SessionMetrics, DynamicMetrics),
        a ``guard.TransferMeter``, or any object with numeric attrs."""
        if isinstance(metrics, guard.TransferMeter):
            self.counter(f"{prefix}.transfers", metrics.transfers)
            self.counter(f"{prefix}.elements", metrics.elements)
            for reason, (n, elems) in metrics.by_reason().items():
                self.counter(f"{prefix}.reason.{reason}", n)
            return
        if is_dataclass(metrics):
            pairs = [(f.name, getattr(metrics, f.name)) for f in fields(metrics)]
        else:
            pairs = [(k, v) for k, v in vars(metrics).items()
                     if not k.startswith("_")]
        for name, value in pairs:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            self.counter(f"{prefix}.{name}", float(value))

    def snapshot(self) -> TelemetrySnapshot:
        return TelemetrySnapshot(
            counters=dict(self.counters),
            gauges=dict(self.gauges),
            histograms={k: h.summary() for k, h in self.histograms.items()},
        )


# --------------------------------------------------------------------------
# Exporters
# --------------------------------------------------------------------------


def _json_default(obj):
    """Span attrs may carry numpy scalars (counter fetches); unwrap them."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    return str(obj)


def export_chrome_trace(tracer: Tracer, path: str) -> None:
    """Chrome/Perfetto trace JSON (load in ui.perfetto.dev or
    chrome://tracing). One complete ("X") event per span; counters and
    per-reason transfer attribution ride in ``args``."""
    events = []
    for s in sorted(tracer.spans, key=lambda s: s.index):
        args: Dict[str, Any] = dict(s.attrs)
        args["transfers"] = s.transfers
        args["elements"] = s.elements
        if s.by_reason:
            args["transfer_reasons"] = s.by_reason
        events.append({
            "name": s.name,
            "ph": "X",
            "cat": "repro",
            "pid": 1,
            "tid": 1,
            "ts": s.start * 1e6,      # Chrome trace wants microseconds
            "dur": s.duration * 1e6,
            "args": args,
        })
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=_json_default)


def export_jsonl(tracer: Optional[Tracer], snapshot: Optional[TelemetrySnapshot],
                 path: str) -> None:
    """One JSON object per line: ``span`` records (close order) then one
    final ``snapshot`` record. Harness-friendly: grep/jq-able, appendable."""
    with open(path, "w") as f:
        if tracer is not None:
            for s in tracer.spans:
                f.write(json.dumps({
                    "type": "span", "name": s.name, "index": s.index,
                    "parent": s.parent, "depth": s.depth,
                    "start_s": s.start, "duration_s": s.duration,
                    "transfers": s.transfers, "elements": s.elements,
                    "by_reason": s.by_reason, "attrs": s.attrs,
                }, default=_json_default) + "\n")
        if snapshot is not None:
            f.write(json.dumps({"type": "snapshot", **snapshot.to_dict()}) + "\n")


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def export_prometheus(snapshot: TelemetrySnapshot, path: str) -> None:
    """Prometheus text exposition format: counters as ``_total``,
    gauges verbatim, histograms as quantile-labeled summaries."""
    lines: List[str] = []
    for name in sorted(snapshot.counters):
        pname = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {snapshot.counters[name]:g}")
    for name in sorted(snapshot.gauges):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {snapshot.gauges[name]:g}")
    for name in sorted(snapshot.histograms):
        summ = snapshot.histograms[name]
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'{pname}{{quantile="{q}"}} {summ[key]:g}')
        lines.append(f"{pname}_count {summ['count']:g}")
        lines.append(f"{pname}_sum {summ['sum']:g}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_telemetry(out_dir: str, tracer: Optional[Tracer] = None,
                    registry: Optional[MetricsRegistry] = None) -> Dict[str, str]:
    """The one-call launcher hook: write ``trace.json`` (Perfetto),
    ``spans.jsonl`` and ``metrics.prom`` under ``out_dir``. Returns the
    paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    snapshot = registry.snapshot() if registry is not None else None
    if tracer is not None:
        trace_path = os.path.join(out_dir, "trace.json")
        export_chrome_trace(tracer, trace_path)
        written["trace"] = trace_path
    if tracer is not None or snapshot is not None:
        jsonl_path = os.path.join(out_dir, "spans.jsonl")
        export_jsonl(tracer, snapshot, jsonl_path)
        written["jsonl"] = jsonl_path
    if snapshot is not None:
        prom_path = os.path.join(out_dir, "metrics.prom")
        export_prometheus(snapshot, prom_path)
        written["prom"] = prom_path
    return written

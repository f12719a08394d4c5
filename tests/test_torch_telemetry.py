"""The port's telemetry (``repro_torch/runtime/telemetry.py``): the
counterparts of the reference's ``tests/test_telemetry.py`` cases (span
nesting and exclusive transfer attribution, the meter's bounded per-reason
aggregation, streaming-histogram quantiles against numpy, the three
exporters, registry ingestion, and the read equalities with tracing on),
then parity with the reference: the same values give the same histogram
quantiles, the same registry gives byte-identical ``metrics.prom`` text,
and a traced decomposition or cascade query gives the reference's span
sequence. Last, both launchers' ``--telemetry-out``.

The span parity compares names, start order, depth, parents and the
algorithmic attributes (``stage``, ``level``, ``n``, ``centers``,
``supersteps``, ``clusters``, ``edges``, ``variant``, ``dynamic``). It
leaves out the backend counters (``kernel_launches``, ``grow_calls``,
``dma_stall_blocks``) and the read counts (each span's transfers, a
cascade level's ``syncs``): the port reads once per chunk of supersteps
where the reference reads once per stage, so these differ by design.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import json
import os

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.analysis import guard as ref_guard  # noqa: E402
from repro.core import CascadeEstimator as RefCascade  # noqa: E402
from repro.core import cluster as ref_cluster  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.core.session import SessionMetrics as RefSessionMetrics  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.runtime import telemetry as ref_telemetry  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.core import (CascadeEstimator,  # noqa: E402
                              ClusterQuotientEstimator, open_session)
from repro_torch.core.cluster import cluster  # noqa: E402
from repro_torch.core.session import SessionMetrics  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.launch import diameter as diameter_launcher  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.runtime.telemetry import (MetricsRegistry,  # noqa: E402
                                           StreamingHistogram, Tracer,
                                           export_chrome_trace, export_jsonl,
                                           export_prometheus, write_telemetry)

CPU = torch.device("cpu")
SPAN_ATTRS = ("stage", "level", "n", "centers", "supersteps", "clusters",
              "edges", "variant", "dynamic")
TELEMETRY_FILES = {"trace.json", "spans.jsonl", "metrics.prom"}


def _t(n):
    return torch.arange(n)


# ---------------------------------------------------------------------------
# span tracer: nesting, null path, exclusive attribution
# ---------------------------------------------------------------------------


class TestTracer:
    def test_span_without_tracer_is_null_singleton(self):
        s1 = telemetry.span("a", x=1)
        s2 = telemetry.span("b")
        assert s1 is s2 is telemetry.NULL_SPAN
        with s1 as sp:           # usable, inert
            sp.set(anything=2)

    def test_nesting_parent_child_indices(self):
        t = Tracer()
        with telemetry.tracing(t):
            with telemetry.span("outer"):
                with telemetry.span("inner.a"):
                    pass
                with telemetry.span("inner.b"):
                    pass
        by_name = {s.name: s for s in t.spans}
        outer, a, b = by_name["outer"], by_name["inner.a"], by_name["inner.b"]
        assert outer.parent is None and outer.depth == 0
        assert a.parent == outer.index and a.depth == 1
        assert b.parent == outer.index and b.depth == 1
        assert a.index < b.index               # start order
        assert t.spans[-1].name == "outer"     # close order
        assert outer.duration >= a.duration + b.duration - 1e-9

    def test_non_lifo_close_raises(self):
        t = Tracer()
        with telemetry.tracing(t):
            s1 = telemetry.span("a")
            s2 = telemetry.span("b")
            s1.__enter__()
            s2.__enter__()
            with pytest.raises(RuntimeError):
                s1.__exit__(None, None, None)
            s2.__exit__(None, None, None)
            s1.__exit__(None, None, None)

    def test_exclusive_attribution_partitions_measured(self):
        """Under a root span the per-span EXCLUSIVE transfer counts sum to
        the measured total: every fetch belongs to the innermost live
        span."""
        t = Tracer()
        with telemetry.tracing(t), guard.metered() as meter:
            with telemetry.span("root"):
                guard.fetch(_t(4), reason="root-level fetch")
                with telemetry.span("child"):
                    guard.fetch(_t(8), reason="child fetch")
                    guard.fetch(_t(2), reason="child fetch")
                with telemetry.span("empty-child"):
                    pass
        assert meter.transfers == 3
        assert t.total_transfers() == meter.transfers
        by_name = {s.name: s for s in t.spans}
        assert by_name["child"].transfers == 2
        assert by_name["child"].elements == 10
        assert by_name["root"].transfers == 1          # exclusive
        assert by_name["root"].transfers_incl == 3     # inclusive
        assert by_name["empty-child"].transfers == 0
        assert by_name["child"].by_reason == {"child fetch": 2}
        attr = t.attribution()
        assert attr["root"] == {"root-level fetch": 1}
        assert "empty-child" not in attr

    def test_tracing_adds_no_transfers(self):
        def work():
            with telemetry.span("w"):
                guard.fetch(_t(3), reason="work")

        with guard.metered() as m_off:
            work()                      # no tracer installed -> NULL_SPAN
        with telemetry.tracing(Tracer()), guard.metered() as m_on:
            work()
        assert m_on.transfers == m_off.transfers == 1
        assert m_on.elements == m_off.elements


# ---------------------------------------------------------------------------
# TransferMeter: bounded per-reason aggregation
# ---------------------------------------------------------------------------


class TestTransferMeterAggregation:
    def test_ten_thousand_fetches_aggregate_not_accumulate(self):
        x = _t(5)
        with guard.metered() as m:
            for i in range(10_000):
                guard.fetch(x, reason=f"reason-{i % 3}")
        assert m.transfers == 10_000
        assert m.elements == 50_000
        assert not hasattr(m, "events")
        assert len(m.reason_counts) == 3
        assert m.reasons() == ["reason-0", "reason-1", "reason-2"]
        assert m.by_reason()["reason-1"] == (3333, 16665)
        counts = m.by_reason()
        assert sum(c for c, _ in counts.values()) == 10_000
        assert sum(e for _, e in counts.values()) == 50_000

    def test_reasons_first_seen_order_distinct(self):
        with guard.metered() as m:
            guard.fetch(_t(1), reason="b")
            guard.fetch(_t(1), reason="a")
            guard.fetch(_t(1), reason="b")
        assert m.reasons() == ["b", "a"]

    def test_pop_meter_non_lifo_raises(self):
        m1 = guard.push_meter()
        m2 = guard.push_meter()
        with pytest.raises(RuntimeError):
            guard.pop_meter(m1)
        guard.pop_meter(m2)
        guard.pop_meter(m1)


# ---------------------------------------------------------------------------
# streaming histogram: quantiles vs numpy on adversarial distributions
# ---------------------------------------------------------------------------


def _fill(values, cls=StreamingHistogram):
    h = cls()
    for v in values:
        h.record(float(v))
    return h


class TestStreamingHistogram:
    def test_empty_histogram_is_all_zero(self):
        h = StreamingHistogram()
        assert h.quantile(0.5) == 0.0
        assert h.summary() == {"count": 0, "sum": 0.0, "min": 0.0,
                               "max": 0.0, "mean": 0.0, "p50": 0.0,
                               "p95": 0.0, "p99": 0.0}

    def test_constant_distribution_is_exact(self):
        h = _fill([3.25] * 1000)
        for q in (0.01, 0.5, 0.95, 0.99, 1.0):
            assert h.quantile(q) == pytest.approx(3.25, rel=1e-12)
        assert h.summary()["mean"] == pytest.approx(3.25)

    def test_bimodal_distribution(self):
        h = _fill([0.001] * 500 + [1000.0] * 500)
        assert h.quantile(0.25) == pytest.approx(0.001, rel=0.05)
        assert h.quantile(0.75) == pytest.approx(1000.0, rel=0.05)
        assert h.quantile(0.0) == pytest.approx(0.001, rel=0.05)
        assert h.quantile(1.0) == pytest.approx(1000.0, rel=1e-12)

    def test_heavy_tail_vs_numpy(self):
        vals = np.random.default_rng(7).lognormal(2.0, 1.5, size=20_000)
        h = _fill(vals)
        for q in (0.5, 0.95, 0.99):
            ref = float(np.percentile(vals, q * 100))
            assert h.quantile(q) == pytest.approx(ref, rel=0.08), q

    def test_uniform_vs_numpy(self):
        vals = np.random.default_rng(3).uniform(0.5, 100.0, size=10_000)
        h = _fill(vals)
        for q in (0.5, 0.95, 0.99):
            ref = float(np.percentile(vals, q * 100))
            assert h.quantile(q) == pytest.approx(ref, rel=0.08), q

    def test_merge_is_associative_and_matches_single_pass(self):
        rng = np.random.default_rng(11)
        a, b, c = (rng.exponential(5.0, size=3000) for _ in range(3))
        hab_c = _fill(a)
        hab_c.merge(_fill(b))
        habc1 = StreamingHistogram()
        habc1.merge(hab_c)
        habc1.merge(_fill(c))
        hbc = _fill(b)
        hbc.merge(_fill(c))
        habc2 = _fill(a)
        habc2.merge(hbc)
        one = _fill(np.concatenate([a, b, c]))
        for q in (0.5, 0.95, 0.99):
            assert habc1.quantile(q) == pytest.approx(habc2.quantile(q),
                                                      rel=1e-12)
            assert habc1.quantile(q) == pytest.approx(one.quantile(q),
                                                      rel=1e-12)
        assert habc1.summary()["count"] == 9000

    def test_negative_and_nan_rejected(self):
        h = StreamingHistogram()
        with pytest.raises(ValueError):
            h.record(-1.0)
        with pytest.raises(ValueError):
            h.record(float("nan"))

    def test_tiny_values_hit_underflow_bucket(self):
        h = _fill([0.0, 1e-15, 1e-13])
        assert h.summary()["count"] == 3
        assert h.quantile(0.5) == pytest.approx(0.0, abs=1e-12)


# ---------------------------------------------------------------------------
# exporters: Perfetto round-trip, JSONL, Prometheus
# ---------------------------------------------------------------------------


def _traced_tracer():
    t = Tracer()
    with telemetry.tracing(t):
        with telemetry.span("outer", stage=1):
            guard.fetch(_t(6), reason="outer fetch")
            with telemetry.span("inner", level=2) as sp:
                guard.fetch(_t(4), reason="inner fetch")
                sp.set(supersteps=7)
    return t


class TestExporters:
    def test_chrome_trace_round_trip(self, tmp_path):
        t = _traced_tracer()
        path = tmp_path / "trace.json"
        export_chrome_trace(t, str(path))
        events = json.loads(path.read_text())["traceEvents"]
        assert [e["name"] for e in events] == ["outer", "inner"]
        outer, inner = events
        assert all(e["ph"] == "X" for e in events)
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0
        assert outer["args"]["stage"] == 1
        assert outer["args"]["transfers"] == 1          # exclusive
        assert inner["args"]["supersteps"] == 7
        assert inner["args"]["transfers"] == 1
        assert inner["args"]["elements"] == 4
        assert inner["args"]["transfer_reasons"] == {"inner fetch": 1}

    def test_jsonl_spans_and_snapshot(self, tmp_path):
        t = _traced_tracer()
        reg = MetricsRegistry()
        reg.counter("c", 3)
        reg.observe("lat", 0.5)
        path = tmp_path / "spans.jsonl"
        export_jsonl(t, reg.snapshot(), str(path))
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        spans = [ln for ln in lines if ln["type"] == "span"]
        snap = [ln for ln in lines if ln["type"] == "snapshot"]
        assert len(spans) == 2 and len(snap) == 1
        inner = next(s for s in spans if s["name"] == "inner")
        outer = next(s for s in spans if s["name"] == "outer")
        assert inner["parent"] == outer["index"]
        assert inner["by_reason"] == {"inner fetch": 1}
        assert snap[0]["counters"]["c"] == 3
        assert snap[0]["histograms"]["lat"]["count"] == 1

    def test_prometheus_text(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("engine.host_syncs", 4)
        reg.gauge("pool.sessions", 2)
        for v in (0.1, 0.2, 0.3):
            reg.observe("serve.latency.cascade", v)
        path = tmp_path / "metrics.prom"
        export_prometheus(reg.snapshot(), str(path))
        text = path.read_text()
        assert "engine_host_syncs_total 4" in text
        assert "pool_sessions 2" in text
        assert 'serve_latency_cascade{quantile="0.5"}' in text
        assert "serve_latency_cascade_count 3" in text

    def test_write_telemetry_bundle(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("x", 1)
        paths = write_telemetry(str(tmp_path), tracer=_traced_tracer(),
                                registry=reg)
        assert set(paths) == {"trace", "jsonl", "prom"}
        assert {os.path.basename(p) for p in paths.values()} == \
            TELEMETRY_FILES
        assert all(os.path.exists(p) for p in paths.values())
        json.loads(open(paths["trace"]).read())   # parses

    def test_numpy_scalar_attrs_serialize(self, tmp_path):
        t = Tracer()
        with telemetry.tracing(t):
            with telemetry.span("s") as sp:
                sp.set(k=np.int32(5), v=np.float64(1.5))
        export_chrome_trace(t, str(tmp_path / "t.json"))
        args = json.loads((tmp_path / "t.json").read_text())[
            "traceEvents"][0]["args"]
        assert args["k"] == 5 and args["v"] == 1.5


# ---------------------------------------------------------------------------
# registry ingestion of the port's metrics dataclasses
# ---------------------------------------------------------------------------


class TestMetricsRegistry:
    def test_ingest_dataclass_and_meter(self):
        sm = SessionMetrics()
        sm.sessions_opened = 2
        sm.queries = 5
        with guard.metered() as m:
            guard.fetch(_t(3), reason="r1")
            guard.fetch(_t(3), reason="r1")
        reg = MetricsRegistry()
        reg.ingest(sm, "session")
        reg.ingest(m, "serve.transfers")
        snap = reg.snapshot()
        assert snap.counters["session.sessions_opened"] == 2
        assert snap.counters["session.queries"] == 5
        assert snap.counters["serve.transfers.transfers"] == 2
        assert snap.counters["serve.transfers.elements"] == 6
        assert snap.counters["serve.transfers.reason.r1"] == 2

    def test_histogram_summary_in_snapshot(self):
        reg = MetricsRegistry()
        for v in range(1, 101):
            reg.observe("lat", float(v))
        s = reg.snapshot().histograms["lat"]
        assert s["count"] == 100
        assert s["p50"] == pytest.approx(50.0, rel=0.1)
        assert s["p99"] == pytest.approx(99.0, rel=0.1)


# ---------------------------------------------------------------------------
# the read equalities under tracing
# ---------------------------------------------------------------------------


def _graph():
    return gen.random_geometric(512, 6.0, seed=1)


def _ref_graph():
    return ref_gen.random_geometric(512, 6.0, seed=1)


class TestEqualityContractsUnderTracing:
    @pytest.mark.parametrize("tau", [12, 4])
    def test_stages_equality_holds_traced(self, tau):
        """Every read of a traced decomposition is counted and attributed
        to a span (tau 12 keeps n below the stop threshold: finalize only;
        tau 4 runs the stage loop)."""
        t = Tracer()
        with telemetry.tracing(t), guard.measured_transfers() as meter:
            dec = cluster(_graph(), tau, seed=0, backend="single",
                          device=CPU)
        m = dec.metrics
        assert meter.transfers == m.host_syncs + m.finalize_syncs
        assert t.total_transfers() == meter.transfers
        assert "engine.finalize" in {s.name for s in t.spans}

    def test_pipeline_equality_holds_traced(self):
        t = Tracer()
        with telemetry.tracing(t):
            with open_session(_graph(), tau=12, device=CPU) as sess:
                with guard.measured_transfers() as meter:
                    res = sess.estimate(ClusterQuotientEstimator())
        assert meter.transfers == res.pipeline.total_host_syncs

    def test_traced_equals_untraced_decomposition(self):
        with guard.measured_transfers() as m_off:
            dec_off = cluster(_graph(), 4, seed=0, device=CPU)
        with telemetry.tracing(Tracer()), \
                guard.measured_transfers() as m_on:
            dec_on = cluster(_graph(), 4, seed=0, device=CPU)
        assert m_on.transfers == m_off.transfers
        np.testing.assert_array_equal(dec_on.final_c, dec_off.final_c)
        np.testing.assert_array_equal(dec_on.final_pathw,
                                      dec_off.final_pathw)

    def test_traced_cascade_equals_untraced(self):
        """A cascade query traced and untraced: the same estimate and the
        same reads, every one of them attributed to a span."""
        def query(traced):
            t = Tracer() if traced else None
            with open_session(_graph(), tau=16, device=CPU) as sess:
                with (telemetry.tracing(t) if traced else _null()), \
                        guard.measured_transfers() as meter:
                    res = sess.estimate(CascadeEstimator(levels=2,
                                                         tau_solve=16))
            return res, meter, t

        off, m_off, _ = query(False)
        on, m_on, t = query(True)
        assert m_on.transfers == m_off.transfers == \
            on.pipeline.total_host_syncs
        assert t.total_transfers() == m_on.transfers
        assert (on.phi_approx, on.pipeline.level_clusters) == \
            (off.phi_approx, off.pipeline.level_clusters)
        np.testing.assert_array_equal(on.decomposition.final_c,
                                      off.decomposition.final_c)


def _null():
    import contextlib

    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draw", ["lognormal", "uniform", "bimodal",
                                  "tiny"])
def test_histogram_quantiles_equal_the_reference(draw):
    rng = np.random.default_rng(5)
    vals = {"lognormal": lambda: rng.lognormal(1.0, 2.0, 5000),
            "uniform": lambda: rng.uniform(0.0, 10.0, 5000),
            "bimodal": lambda: np.r_[np.full(50, 1e-3), np.full(70, 1e3)],
            "tiny": lambda: np.r_[0.0, 1e-14, rng.uniform(0, 1e-11, 20)],
            }[draw]()
    h, r = _fill(vals), _fill(vals, ref_telemetry.StreamingHistogram)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.quantile(q) == r.quantile(q)
    assert h.summary() == r.summary()


def test_metrics_prom_byte_identical_to_the_reference(tmp_path):
    ours, theirs = MetricsRegistry(), ref_telemetry.MetricsRegistry()
    sm, rsm = SessionMetrics(), RefSessionMetrics()
    for m in (sm, rsm):
        m.sessions_opened, m.queries, m.warm_queries = 2, 7, 5
    with guard.metered() as meter:
        guard.fetch(_t(3), reason="stage stop decision")
        guard.fetch(_t(9), reason="finalize: planes")
    with ref_guard.metered() as ref_meter:
        ref_guard.fetch(np.arange(3), reason="stage stop decision")
        ref_guard.fetch(np.arange(9), reason="finalize: planes")
    lat = np.random.default_rng(2).lognormal(-3.0, 1.0, 200)
    for reg, s, mt in ((ours, sm, meter), (theirs, rsm, ref_meter)):
        reg.ingest(s, "session")
        reg.ingest(mt, "serve.transfers")
        reg.counter("engine.host_syncs", 4)
        reg.gauge("pool.sessions", 2)
        for v in lat:
            reg.observe("serve.latency.cascade", float(v))
            reg.observe("serve.latency.cascade.warm", float(v))
    export_prometheus(ours.snapshot(), str(tmp_path / "ours.prom"))
    ref_telemetry.export_prometheus(theirs.snapshot(),
                                    str(tmp_path / "theirs.prom"))
    assert (tmp_path / "ours.prom").read_bytes() == \
        (tmp_path / "theirs.prom").read_bytes()


def _spans(tracer):
    return [(s.index, s.name, s.depth, s.parent,
             {k: v for k, v in s.attrs.items() if k in SPAN_ATTRS})
            for s in sorted(tracer.spans, key=lambda s: s.index)]


@pytest.mark.parametrize("tau", [12, 4])
def test_cluster_spans_equal_the_reference(tau):
    with telemetry.tracing() as t:
        cluster(_graph(), tau, seed=0, backend="single", device=CPU)
    with ref_telemetry.tracing() as rt:
        ref_cluster(_ref_graph(), tau, seed=0)
    assert _spans(t) == _spans(rt)
    names = [s.name for s in t.spans]
    assert names.count("engine.finalize") == 1
    assert ("engine.stage" in names) == (tau == 4)


def test_cascade_query_spans_equal_the_reference():
    """A tau-16 two-level cascade query: level 0, both re-entrant levels
    (their stages nested in ``cascade.level``), the quotient builds and
    the solve, span for span."""
    with telemetry.tracing() as t:
        with open_session(_graph(), tau=16, backend="single",
                          device=CPU) as sess:
            res = sess.estimate(CascadeEstimator(levels=2, tau_solve=16))
    with ref_telemetry.tracing() as rt:
        with ref_open_session(_ref_graph(), tau=16) as rsess:
            ref = rsess.estimate(RefCascade(levels=2, tau_solve=16))
    assert res.pipeline.cascade_levels == ref.pipeline.cascade_levels == 2
    assert res.phi_approx == ref.phi_approx
    assert _spans(t) == _spans(rt)
    names = [s.name for s in t.spans]
    for want in ("session.open", "engine.finalize", "quotient.build",
                 "cascade.level", "engine.stage", "quotient.solve"):
        assert want in names


# ---------------------------------------------------------------------------
# --telemetry-out on both launchers
# ---------------------------------------------------------------------------


def test_diameter_launcher_telemetry_out(tmp_path, capsys):
    out_dir = tmp_path / "tele"
    assert diameter_launcher.main(
        ["--n", "600", "--tau", "4", "--device", "cpu", "--backend",
         "single", "--levels", "1", "--tau-solve", "8",
         "--telemetry-out", str(out_dir)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(os.listdir(out_dir)) == TELEMETRY_FILES
    events = json.loads((out_dir / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names[0] == "session.open" and "quotient.solve" in names
    assert sum(e["args"]["transfers"] for e in events) == out["host_syncs"]
    prom = (out_dir / "metrics.prom").read_text()
    assert "pipeline_solve_syncs_total" in prom
    assert "session_queries_total 1" in prom


def test_serve_graph_diameter_telemetry_out(tmp_path, capsys):
    out_dir = tmp_path / "tele"
    rc = serve.main(["--mode", "graph-diameter", "--device", "cpu",
                     "--batch", "2", "--graph-n", "300", "--queries", "2",
                     "--tau", "4", "--estimator", "cascade",
                     "--update-trace", "2", "--telemetry-out", str(out_dir)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["failures"] == []
    assert out["transfers"] == out["counted_host_syncs"]
    assert set(os.listdir(out_dir)) == TELEMETRY_FILES
    spans = [json.loads(ln) for ln in
             (out_dir / "spans.jsonl").read_text().splitlines()]
    names = [s["name"] for s in spans if s["type"] == "span"]
    assert names.count("serve.replay") == 1
    assert names.count("serve.query") == 4
    assert names.count("serve.update") == 2
    queries = [s for s in spans if s.get("name") == "serve.query"]
    assert [q["attrs"]["host_syncs"] for q in queries] == \
        [q["host_syncs"] for q in out["per_query"]]
    snap = spans[-1]
    assert snap["type"] == "snapshot"
    assert snap["histograms"]["serve.latency.cascade"]["count"] == 4
    assert snap["histograms"]["serve.latency.cascade.warm"]["count"] == 2
    assert snap["counters"]["serve.transfers.transfers"] == out["transfers"]
    assert "dynamic.g0.update_syncs" in snap["counters"]

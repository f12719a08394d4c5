"""Serving launcher, the port of the JAX package's ``launch/serve.py``.

``--mode lm`` (default): batched LM prefill and steady-state decode with a
KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --batch 4 --prompt-len 32 --gen 16 [--smoke] [--temperature 0.7] \
      [--device cuda]

As in the reference, the weights are randomly initialised (seed 0) and the
prompt is streamed through ``decode_step`` one position at a time, so the
prefill and the decode run the same step. Sampling is greedy, or draws
from ``softmax(logits / temperature)`` with an explicit ``torch.Generator``.
Prints the prefill and decode rates, ``ids[0, :8]``, and one JSON line of
the run's numbers.

``--mode graph-diameter``: diameter queries on resident graphs. Every
graph is opened ONCE into a ``SessionPool`` (one shared edge-pad bucket);
each session then serves ``--queries`` rounds of queries.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode graph-diameter \
      --batch 8 --graph-n 2000 --queries 3 [--graph road|social|mesh] \
      [--tau 12] [--estimator cluster|sssp|lower|interval|cascade] \
      [--levels 2] [--tau-solve 64] [--autotune off|auto|record] \
      [--engine-mode stages|oneshot|auto] [--deterministic] \
      [--backend single|kernel] [--device cuda] \
      [--check-amortization 2.0] [--sync-budget off|<int>] \
      [--update-trace 4 [--update-events 0] [--update-mix mixed] \
       [--check-update-cost 5] [--bracket-rounds 4]] \
      [--shards 4] [--checkpoint-dir DIR [--resume] [--preempt-after K]] \
      [--telemetry-out DIR]

With ``--update-trace N`` the run is a DYNAMIC replay: each session gets a
seeded ``temporal_trace`` of N batches (``--update-events`` undirected
events a batch, 0 = 0.5% of the edges; ``--update-mix``), one batch is
applied between query rounds, the rest after them, and every session
ends with an ``IntervalEstimator`` bracket (its farthest-point lower side
runs ``--bracket-rounds`` SSSPs; 0 leaves the lower side at 0). The
default estimator becomes ``dynamic`` (the maintained bound). The
amortized update supersteps are reported against the last full
decomposition's (``--check-update-cost C`` fails above 1/C of it).

``--shards N`` (> 1) backs every session with an N-shard ``GraphStore``.
``--checkpoint-dir D`` saves every stages decomposition at each stage
boundary (session ``i`` under ``D/g<i>``) under one process-level
``PreemptionGuard``: a SIGTERM saves and the run exits with
``EXIT_PREEMPTED`` (75), and ``--resume`` finishes from the saved steps
byte-identically. ``--preempt-after K`` (a test hook) sends a real SIGTERM
at boundary K of the first session's first decomposition.

Contracts (exit 1 when one fails): from round 1 on no query builds a
backend or uploads an edge array (``SessionMetrics``; updates mutate the
resident store, counted in ``DynamicMetrics``); every host read is a
counted one (``guard.measured_transfers()`` equals the queries' summed
``total_host_syncs`` and ``checkpoint_syncs`` plus the updates'
``update_syncs`` and ``engine_syncs``; on the card the replay runs under
sync debug mode "error", so a read that bypasses ``guard.fetch`` raises);
``--check-amortization`` (cold over steady query time) and
``--sync-budget`` (a query's host reads; an interval is judged by its
worst member). Records are collected in the loop and written after it.
Prints one JSON line of the run's numbers. ``--telemetry-out DIR`` traces
the opens and the replay (``serve.replay``, ``serve.update``,
``serve.query`` and the engine's spans below them), keeps the query
latencies as ``serve.latency.<estimator>`` histograms (and ``.cold`` /
``.warm``), and writes ``trace.json``, ``spans.jsonl`` and
``metrics.prom`` under DIR after the loop.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Any, Dict, List, Optional

import torch

from repro_torch.common import Timer, get_logger, resolve_device
from repro_torch.config.registry import get_arch
from repro_torch.launch.diameter import (add_query_arguments,
                                         add_telemetry_argument, build_graph,
                                         check_query_arguments)
from repro_torch.models import transformer as tf_mod
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault import (EXIT_PREEMPTED, Preempted,
                                       PreemptionGuard)

log = get_logger("repro_torch.serve")

SEED = 0

ESTIMATORS = ("cluster", "sssp", "lower", "interval", "cascade", "dynamic")

# update-trace event mixes: (p_insert, p_reweight, p_delete)
UPDATE_MIXES = {"insert": (1.0, 0.0, 0.0),
                "mixed": (0.4, 0.4, 0.2),
                "delete": (0.1, 0.1, 0.8)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", default="lm", choices=["lm", "graph-diameter"])
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="LM: sequences; graph-diameter: graphs (seeds "
                         "0..batch-1)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    # graph-diameter mode (and --device for both modes)
    add_query_arguments(ap)
    ap.add_argument("--graph-n", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=2,
                    help="diameter queries per resident session")
    ap.add_argument("--estimator", default=None, choices=ESTIMATORS,
                    help="default: the session's own (the paper pipeline, "
                         "or under --autotune the record's cascade)")
    ap.add_argument("--check-amortization", type=float, default=0.0,
                    help="fail unless cold/steady query time reaches this "
                         "ratio (0 = off)")
    ap.add_argument("--sync-budget", default="off",
                    help="per-query host-read ceiling: off | <int>")
    ap.add_argument("--update-trace", type=int, default=0,
                    help="replay this many temporal_trace batches per "
                         "session between the query rounds (0 = static)")
    ap.add_argument("--update-events", type=int, default=0,
                    help="events per batch (0 = 0.5%% of the edges)")
    ap.add_argument("--update-mix", default="mixed",
                    choices=sorted(UPDATE_MIXES))
    ap.add_argument("--check-update-cost", type=float, default=0.0,
                    help="fail unless the amortized update supersteps stay "
                         "below the full decomposition's / THIS (0 = off)")
    ap.add_argument("--bracket-rounds", type=int, default=4,
                    help="SSSP rounds of the final bracket's lower side "
                         "(0 = the maintained upper bound alone)")
    ap.add_argument("--shards", type=int, default=0,
                    help="back each session with a GraphStore of this many "
                         "shards (0 = flat storage)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save every session's stages decomposition at "
                         "each stage boundary (subdirectories g0, g1, ...)")
    ap.add_argument("--resume", action="store_true",
                    help="continue the decompositions from the latest "
                         "steps in --checkpoint-dir")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="test hook: a real SIGTERM at this stage boundary "
                         "of the first session's first decomposition "
                         "(requires --checkpoint-dir)")
    add_telemetry_argument(ap)
    args = ap.parse_args(argv)
    if args.mode == "graph-diameter":
        _check_graph_args(ap, args)
        return args
    for name in ("batch", "prompt_len", "gen"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if args.temperature < 0:
        ap.error("--temperature must be >= 0")
    return args


def _check_graph_args(ap: argparse.ArgumentParser, args) -> None:
    """Refuse what the port cannot serve, before any graph or device work."""
    if args.sync_budget == "bench":
        ap.error("--sync-budget bench reads BENCH_engine.json, which records "
                 "the JAX package's host reads, not the port's (the port "
                 "reads once per chunk of supersteps); pass off or <int>")
    if args.sync_budget != "off":
        try:
            int(args.sync_budget)
        except ValueError:
            ap.error(f"--sync-budget must be off | <int> "
                     f"(got {args.sync_budget!r})")
    for name in ("batch", "queries", "graph_n"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    for name in ("update_trace", "update_events", "bracket_rounds", "shards",
                 "preempt_after"):
        if getattr(args, name) < 0:
            ap.error(f"--{name.replace('_', '-')} must be >= 0")
    for name in ("resume", "preempt_after"):
        if getattr(args, name) and not args.checkpoint_dir:
            ap.error(f"--{name.replace('_', '-')} requires --checkpoint-dir")
    check_query_arguments(ap, args)


def _make_estimator(name: Optional[str], levels: int = 0):
    """The query's estimator; None leaves the choice to the session."""
    from repro_torch.core import (CascadeEstimator, ClusterQuotientEstimator,
                                  DeltaSteppingEstimator,
                                  DynamicQuotientEstimator, IntervalEstimator,
                                  LowerBoundEstimator)

    if name is None:
        return None
    if name == "cascade":
        # --levels 0 with an explicit --estimator cascade keeps the
        # estimator's own default depth
        return CascadeEstimator(levels=levels) if levels else CascadeEstimator()
    return {"cluster": ClusterQuotientEstimator,
            "sssp": DeltaSteppingEstimator,
            "lower": LowerBoundEstimator,
            "interval": IntervalEstimator,
            "dynamic": DynamicQuotientEstimator}[name]()


def _final_bracket(rounds: int):
    """The replay's closing bracket: the default panel (farthest point
    with ``rounds`` SSSPs, and the maintained upper bound), or the upper
    bound alone for ``rounds = 0`` (lower 0)."""
    from repro_torch.core import (DynamicQuotientEstimator, IntervalEstimator,
                                  LowerBoundEstimator)

    if rounds == 0:
        return IntervalEstimator(estimators=(DynamicQuotientEstimator(),))
    return IntervalEstimator(estimators=(LowerBoundEstimator(rounds=rounds),
                                         DynamicQuotientEstimator()))


def _query_syncs(result) -> int:
    """Host reads to judge against the per-query budget. A composite
    (``DiameterInterval``) is judged by its WORST member: every estimator
    of the panel must stay within the budget on its own."""
    estimates = getattr(result, "estimates", None)
    if estimates:
        return max(_query_syncs(r) for r in estimates.values())
    pm = getattr(result, "pipeline", None)
    return pm.total_host_syncs if pm is not None else 0


def _query_record(i: int, round_idx: int, res, syncs: int, dt: float):
    rec = {"graph": i, "round": round_idx, "seconds": dt, "host_syncs": syncs,
           "total_host_syncs": res.pipeline.total_host_syncs,
           "connected": res.connected}
    if hasattr(res, "estimates"):   # DiameterInterval
        rec.update(lower=res.lower, upper=res.upper)
    else:
        rec.update(method=res.method, phi_approx=res.phi_approx,
                   clusters=res.n_clusters, lower=res.lower, upper=res.upper)
    return rec


def update_traces(graphs: List, args: argparse.Namespace,
                  seeds: Optional[List[int]] = None) -> List:
    """Each graph's seeded ``temporal_trace`` (seed: its index, or
    ``seeds[i]``) of ``args.update_trace`` batches in ``args.update_mix``,
    with ``args.update_events`` events a batch (0: the largest graph's
    ``n_edges // 200``)."""
    from repro_torch.graph import temporal_trace

    p_ins, p_rw, p_del = UPDATE_MIXES[args.update_mix]
    events = args.update_events or max(g.n_edges // 200 for g in graphs)
    seeds = range(len(graphs)) if seeds is None else seeds
    return [temporal_trace(g, args.update_trace, events_per_batch=events,
                           p_insert=p_ins, p_reweight=p_rw, p_delete=p_del,
                           seed=s)
            for s, g in zip(seeds, graphs)]


def _apply_batch(sess, batch, dev: torch.device):
    """One update batch; returns (report, seconds the kernel backend's
    ``rebind`` took, None on the plain backend)."""
    r0 = getattr(sess.backend, "rebind_seconds", None)
    rep = sess.apply_updates(batch)
    _sync(dev)
    r1 = getattr(sess.backend, "rebind_seconds", None)
    return rep, None if r0 is None else r1 - r0


def serve_graph_diameter(args: argparse.Namespace,
                         graphs: Optional[List] = None,
                         traces: Optional[List] = None,
                         e_pad: Optional[int] = None) -> Dict[str, Any]:
    """Steady-state diameter serving on resident pooled sessions.

    ``graphs`` (default: ``build_graph(args.graph, args.graph_n, seed)``
    for seeds 0..batch-1) are opened once into one ``SessionPool`` with one
    shared ``e_pad`` (default: the largest edge count, bucketed); then
    ``args.queries`` rounds query every session. With
    ``args.update_trace``, ``traces`` (default: ``update_traces``) are
    replayed between the rounds and after them, and each session ends with
    a bracket. Returns the run's numbers, the contract failures
    (``failures``) and the estimates (``results``: (graph, round,
    estimate)). With ``args.checkpoint_dir`` the queries run under one
    ``PreemptionGuard``, and a preemption raises ``Preempted`` (after its
    save) out of this function."""
    from repro_torch import guard
    from repro_torch.common import GraphEngineConfig, next_multiple
    from repro_torch.core import SessionPool

    dev = resolve_device(args.device)
    if graphs is None:
        graphs = [build_graph(args.graph, args.graph_n, seed=s)
                  for s in range(args.batch)]
    trace_seconds = None
    if not args.update_trace:
        traces = None
    elif traces is None:
        with Timer() as t_trace:
            traces = update_traces(graphs, args)
        trace_seconds = t_trace.seconds
    cfg = GraphEngineConfig(backend=args.backend, autotune=args.autotune,
                            mode=args.engine_mode,
                            deterministic=args.deterministic)
    # --levels alone activates the cascade; other estimators take no levels
    est_name = args.estimator
    if args.levels and est_name in (None, "cluster"):
        est_name = "cascade"
    elif args.levels and est_name != "cascade":
        log.warning("--levels %d is ignored by --estimator %s", args.levels,
                    est_name)
    if traces and est_name in (None, "cluster"):
        # a replay is served by the maintained bound, not by a new
        # decomposition per query
        est_name = "dynamic"
    estimator = _make_estimator(est_name, levels=args.levels)
    sync_budget = None if args.sync_budget == "off" else int(args.sync_budget)
    if dev.type == "cuda":
        # sync: the timed run starts from an idle card
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    failures: List[str] = []
    records: List[tuple] = []     # (graph, round, result, syncs, seconds)
    updates: List[tuple] = []     # (graph, batch, report, rebind seconds)
    brackets: List[tuple] = []    # (graph, interval, seconds)
    cold: List[float] = []        # each session's first query
    warm: List[float] = []
    pguard = PreemptionGuard() if args.checkpoint_dir else None
    # --telemetry-out arms the span tracer (spans push guard meters and
    # read nothing, so the measured/counted equality below holds with it
    # on) and a registry fed per-estimator latency histograms
    tracer = telemetry.Tracer() if args.telemetry_out else None
    registry = telemetry.MetricsRegistry() if args.telemetry_out else None
    with (telemetry.tracing(tracer) if tracer is not None
          else contextlib.nullcontext()), \
            SessionPool(cfg, tau_solve=args.tau_solve, device=dev,
                        checkpoint_dir=args.checkpoint_dir,
                        shards=args.shards, resume=args.resume,
                        guard=pguard) as pool:
        # one edge-pad bucket across the whole batch
        e_pad = e_pad or next_multiple(max(g.n_edges for g in graphs) or 1,
                                       pool.edge_bucket)
        with Timer() as t_open:
            sessions = [pool.open(g, tau=args.tau, e_pad=e_pad)
                        for g in graphs]
        if args.preempt_after:
            sessions[0].checkpointer.preempt_after_stage = args.preempt_after
        # on the card the replay runs under sync debug mode "error": a read
        # or blocking copy that bypasses guard.fetch raises
        with pguard if pguard is not None else contextlib.nullcontext(), \
                guard.measured_transfers() as meter, Timer() as t_total, \
                telemetry.span("serve.replay", batch=len(graphs),
                               queries=args.queries, estimator=est_name):
            for round_idx in range(args.queries):
                if round_idx == 1:
                    # from here on NOTHING may build a backend or upload
                    builds0 = pool.metrics.backend_builds
                    uploads0 = pool.metrics.edge_uploads
                if round_idx and traces:
                    # one batch per session between rounds, mutating the
                    # resident store in place
                    for i, sess in enumerate(sessions):
                        if round_idx - 1 < len(traces[i]):
                            with telemetry.span("serve.update", graph=i,
                                                batch=round_idx - 1):
                                rep = _apply_batch(
                                    sess, traces[i][round_idx - 1], dev)
                            updates.append((i, round_idx - 1, *rep))
                for i, sess in enumerate(sessions):
                    with Timer() as tq, telemetry.span(
                            "serve.query", graph=i, round=round_idx) as qs:
                        res = sess.estimate(estimator)
                        _sync(dev)
                        syncs = _query_syncs(res)
                        qs.set(host_syncs=syncs)
                    (cold if round_idx == 0 else warm).append(tq.seconds)
                    if registry is not None:
                        lat = f"serve.latency.{est_name or 'default'}"
                        kind = "cold" if round_idx == 0 else "warm"
                        registry.observe(lat, tq.seconds)
                        registry.observe(f"{lat}.{kind}", tq.seconds)
                    records.append((i, round_idx, res, syncs, tq.seconds))
            if traces:
                # drain the batches past the rounds, then bracket each
                # session's final graph
                for i, sess in enumerate(sessions):
                    for b in range(max(args.queries - 1, 0), len(traces[i])):
                        updates.append((i, b, *_apply_batch(
                            sess, traces[i][b], dev)))
                    with Timer() as tb:
                        iv = sess.estimate(_final_bracket(args.bracket_rounds))
                        _sync(dev)
                    brackets.append((i, iv, tb.seconds))
        m = pool.metrics
        dyn = [s.dynamic.metrics for s in sessions if s.dynamic is not None]
        if registry is not None:
            registry.ingest(m, "session")
            registry.ingest(meter, "serve.transfers")
            for i, sess in enumerate(sessions):
                if sess.dynamic is not None:
                    registry.ingest(sess.dynamic.metrics, f"dynamic.g{i}")
            written = telemetry.write_telemetry(args.telemetry_out, tracer,
                                                registry)
            log.info("telemetry: %d spans, %d measured transfers "
                     "attributed -> %s", len(tracer.spans),
                     tracer.total_transfers(), sorted(written.values()))
        backend_launches = [s.backend.launches for s in sessions]
        out: Dict[str, Any] = {
            "mode": "graph-diameter", "graph": args.graph,
            "n": [g.n_nodes for g in graphs],
            "edges": [g.n_edges for g in graphs], "e_pad": e_pad,
            "batch": len(graphs), "queries": args.queries,
            "estimator": est_name or "session default",
            "backend": args.backend, "device": str(dev),
            "autotune": args.autotune,
            "engine_mode": [s.cfg.mode for s in sessions],
            "tau": [s.tau for s in sessions],
            "tau_solve": [s.tau_solve for s in sessions],
            "tuning": [dataclasses.asdict(s.tuning) if s.tuning else None
                       for s in sessions],
            "open_seconds": t_open.seconds,
            "backend_launches": backend_launches,
            "shards": args.shards,
        }
        if args.checkpoint_dir:
            out["checkpoint"] = [
                {"saves": s.checkpointer.saves,
                 "restores": s.checkpointer.restores,
                 "save_seconds": s.checkpointer.save_seconds}
                for s in sessions]
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    if args.queries > 1:
        rebuilds = m.backend_builds - builds0
        reuploads = m.edge_uploads - uploads0
        out.update(warm_backend_builds=rebuilds, warm_edge_uploads=reuploads)
        if rebuilds or reuploads:
            failures.append(f"warm queries must be resident: {rebuilds} "
                            f"rebuilds, {reuploads} re-uploads")
    # a checkpoint save's reads are counted apart from the algorithm's
    counted = (sum(r[2].pipeline.total_host_syncs
                   + r[2].pipeline.checkpoint_syncs for r in records)
               + sum(iv.pipeline.total_host_syncs
                     + iv.pipeline.checkpoint_syncs for _, iv, _ in brackets)
               + sum(d.update_syncs + d.engine_syncs for d in dyn))
    if meter.transfers != counted:
        failures.append(f"{meter.transfers} host reads measured, "
                        f"{counted} counted by the queries and updates")
    if traces:
        upd_steps = sum(d.update_supersteps + d.rebuild_supersteps
                        for d in dyn)
        upd_batches = sum(d.batches for d in dyn)
        baseline = max(d.baseline_supersteps for d in dyn)
        amort_upd = upd_steps / max(upd_batches, 1)
        if args.check_update_cost and baseline and \
                amort_upd * args.check_update_cost > baseline:
            failures.append(
                f"amortized update cost {amort_upd:.1f} supersteps a batch "
                f"exceeds 1/{args.check_update_cost:g} of a full "
                f"decomposition ({baseline})")
        out.update(
            update_trace=args.update_trace, update_mix=args.update_mix,
            update_directed_events=[[b.n_events for b in t] for t in traces],
            trace_seconds=trace_seconds,
            updates=[{"graph": i, "batch": b, **dataclasses.asdict(rep),
                      "rebind_seconds": rb} for i, b, rep, rb in updates],
            dynamic_metrics=[{**dataclasses.asdict(d),
                              "amortized_supersteps": d.amortized_supersteps}
                             for d in dyn],
            final_brackets=[{"graph": i, "lower": iv.lower,
                             "upper": iv.upper, "connected": iv.connected,
                             "host_syncs": iv.pipeline.total_host_syncs,
                             "seconds": secs} for i, iv, secs in brackets],
            update_batches=upd_batches, amortized_update_supersteps=amort_upd,
            baseline_supersteps=baseline,
            full_rebuilds=sum(d.full_rebuilds for d in dyn))
    worst_syncs = max(r[3] for r in records)
    if sync_budget is not None and worst_syncs > sync_budget:
        failures.append(f"host syncs {worst_syncs} exceed the budget "
                        f"{sync_budget}")
    t_cold = cold[0]
    steady = (cold[1:] + warm) or [t_cold]
    per_query = sum(steady) / len(steady)
    amort = t_cold / max(per_query, 1e-9)
    if args.check_amortization and amort < args.check_amortization:
        failures.append(f"amortization {amort:.2f}x below required "
                        f"{args.check_amortization:.2f}x")
    out.update(
        cold_seconds=cold, warm_seconds=warm,
        cold_mean_seconds=sum(cold) / len(cold),
        warm_mean_seconds=sum(warm) / len(warm) if warm else None,
        steady_seconds_per_query=per_query,
        queries_per_second=1.0 / max(per_query, 1e-9),
        amortization=amort, total_seconds=t_total.seconds,
        transfers=meter.transfers, counted_host_syncs=counted,
        worst_query_syncs=worst_syncs, sync_budget=sync_budget,
        session_metrics=dataclasses.asdict(m),
        per_query=[_query_record(*r) for r in records],
        failures=failures,
        results=[(i, r, res) for i, r, res, _, _ in records])
    return out


def serve_graph_main(args: argparse.Namespace) -> int:
    try:
        res = serve_graph_diameter(args)
    except Preempted as p:
        log.warning("preempted at stage %d; checkpoint durable at %s: rerun "
                    "with --resume to finish byte-identically", p.stage,
                    p.path)
        return EXIT_PREEMPTED
    res.pop("results")
    for u in res.get("updates", []):
        log.info("graph[%d] u%d: %s sweeps=%d dead=%d %.3fs", u["graph"],
                 u["batch"], u["action"], u["supersteps"], u["dead_nodes"],
                 u["seconds"])
    for q in res["per_query"]:
        log.info("graph[%d] q%d: %s host_syncs=%d %.3fs", q["graph"],
                 q["round"], f"phi={q['phi_approx']} clusters={q['clusters']}"
                 if "phi_approx" in q else
                 f"diameter in [{q['lower']}, {q['upper']}]",
                 q["host_syncs"], q["seconds"])
    log.info("opened %d sessions; first query %.3fs, steady state %.3fs/query "
             "(%.2f queries/s, %.2fx amortization); %d host reads measured",
             res["batch"], res["cold_seconds"][0],
             res["steady_seconds_per_query"], res["queries_per_second"],
             res["amortization"], res["transfers"])
    log.info("session metrics: %s", res["session_metrics"])
    for b in res.get("final_brackets", []):
        log.info("graph[%d] final bracket [%d, %d] connected=%s", b["graph"],
                 b["lower"], b["upper"], b["connected"])
    if "updates" in res:
        log.info("update replay: %d batches, %.1f supersteps a batch "
                 "amortized against %d for a full decomposition (%d "
                 "rebuilds)", res["update_batches"],
                 res["amortized_update_supersteps"],
                 res["baseline_supersteps"], res["full_rebuilds"])
    for f in res["failures"]:
        log.error("FAIL: %s", f)
    print(json.dumps(res))
    return 1 if res["failures"] else 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        # sync: a timed query or step ends when the card is done
        torch.cuda.synchronize(dev)


def serve_lm(args: argparse.Namespace) -> Dict[str, Any]:
    """Initialise the model, stream the prompts through ``decode_step``,
    decode ``args.gen`` tokens per request; returns the run's numbers and
    the generated ids (int64 ``[batch, gen]``, on the host)."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    with Timer() as t_init:
        params = tf_mod.init_params(cfg, seed=SEED, device=dev)
        _sync(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    cache = tf_mod.init_cache(cfg, args.batch, args.prompt_len + args.gen,
                              device=dev)

    def step(tokens):
        return tf_mod.decode_step(params, cache, tokens, cfg)

    # prefill by streaming the prompt through decode (one step function, as
    # the reference; a batched prefill is prefill_step)
    with Timer() as t_prefill:
        logits = None
        for i in range(args.prompt_len):
            logits, cache = step(prompts[:, i:i + 1])
        _sync(dev)

    toks = []
    with Timer() as t_decode:
        cur = torch.argmax(logits, -1)[:, None]
        for _ in range(args.gen):
            toks.append(cur)
            logits, cache = step(cur)
            if args.temperature > 0:
                probs = torch.softmax(logits / args.temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=gen)
            else:
                cur = torch.argmax(logits, -1)[:, None]
        _sync(dev)

    # sync: LM serving reads the decoded ids once, at the end
    ids = torch.cat(toks, dim=1).cpu()   # one read of all decoded ids
    res = {
        "arch": cfg.name, "params": cfg.param_count(), "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "device": str(dev), "init_seconds": t_init.seconds,
        "prefill_seconds": t_prefill.seconds,
        "prefill_tok_s": args.batch * args.prompt_len / t_prefill.seconds,
        "decode_seconds": t_decode.seconds,
        "decode_tok_s": args.batch * args.gen / t_decode.seconds,
        "decode_tok_s_per_seq": args.gen / t_decode.seconds,
        "decode_ms_per_step": 1e3 * t_decode.seconds / args.gen,
        # sync: LM serving reads the logits' finiteness once, at the end
        "logits_finite": bool(torch.isfinite(logits).all()),
        "ids": ids,
    }
    return res


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode == "graph-diameter":
        return serve_graph_main(args)
    res = serve_lm(args)
    ids = res.pop("ids")
    log.info("prefill %.2fs (%.1f tok/s)  decode %.2fs (%.1f tok/s/seq)",
             res["prefill_seconds"], res["prefill_tok_s"],
             res["decode_seconds"], res["decode_tok_s_per_seq"])
    log.info("generated ids[0,:8] = %s", ids[0, :8].tolist())
    print(json.dumps({**res, "ids0": ids[0, :8].tolist()}))
    return 0 if res["logits_finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Diameter launcher: the paper pipeline on a resident ``GraphSession``.

  PYTHONPATH=src python -m repro_torch.launch.diameter --graph road \
      --n 200000 --tau 16 --backend kernel [--interval] [--device cuda] \
      [--engine-mode stages|oneshot|auto] [--deterministic] [--cluster2] \
      [--levels L --tau-solve T] [--delta-init avg|min|<int>] \
      [--compare-sssp] [--autotune off|auto|record] \
      [--shards 4] [--compress] [--partition range|cluster] \
      [--checkpoint-dir DIR [--resume]] [--telemetry-out DIR]

Prints one JSON line: Phi_approx, the cluster count, quotient size,
supersteps, host reads, kernel launches, seconds and (on CUDA) peak device
memory. ``--levels L`` runs the quotient cascade (``CascadeEstimator``)
and adds its per-level clusters, supersteps and reads. ``--cluster2``
decomposes with CLUSTER2 (paper Algorithm 2). ``--compare-sssp`` runs the
competitor (``DeltaSteppingEstimator``, Bellman-Ford from a random
source) on the same session and adds ``sssp_lower``, ``sssp_upper``,
``sssp_supersteps`` and ``round_ratio`` (its supersteps over CLUSTER's
growing steps). ``--interval`` adds the farthest-point lower bound and
the certified ``[lower, upper]`` bracket. ``--autotune auto`` derives
tau, tau_solve, the cascade depth, delta_init, the fusion depth and the
engine mode from one statistics pass (``core/autotune.py``; explicit flags
stay pinned) and adds the record as ``tuning``; a record with levels runs
its cascade.

``--shards N`` (> 1) or ``--compress`` back the session with a
``GraphStore`` (N shards, slabs held as exact ``pack_i32`` streams under
``--compress``) and add its geometry to the JSON: shards, ``halo_k``, halo
and full-plane bytes per superstep (what a sharded backend would move; the
port has none yet), the host slabs' resident and raw bytes,
decompressions, and the device bytes of the store's edge arrays. Both
backends read those flat, uncompressed device arrays, so neither flag
changes what the card holds or runs, and the estimate is the flat run's.
``--partition cluster``
relabels nodes for a sharded backend only, which the port does not have
yet, so here it changes nothing (the log says so). ``--checkpoint-dir``
saves the decomposition at every stage boundary under a
``PreemptionGuard``; a SIGTERM saves, and the launcher exits with
``EXIT_PREEMPTED`` (75); ``--resume`` finishes from the latest step.
``--telemetry-out DIR`` traces the session's open and every query
(``runtime/telemetry.py``) and writes ``trace.json`` (Perfetto),
``spans.jsonl`` and ``metrics.prom`` under DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math

import torch

from repro_torch.common import (GraphEngineConfig, Timer, get_logger,
                                resolve_device)
from repro_torch.core import (CascadeEstimator, ClusterQuotientEstimator,
                              DeltaSteppingEstimator, IntervalEstimator,
                              LowerBoundEstimator, check_engine_mode,
                              open_session)
from repro_torch.graph import GraphStore, grid_mesh, road_like, social_like
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault import (EXIT_PREEMPTED, Preempted,
                                       PreemptionGuard)

log = get_logger("repro_torch.diameter")


def build_graph(kind: str, n: int, seed: int):
    """The graph families of the reference's launcher (its ``road`` is
    ``random_geometric(n, 3.0)``, which ``road_like`` is)."""
    if kind == "road":
        return road_like(n, seed=seed)
    if kind == "social":
        return social_like(max(int(math.log2(max(n, 2))), 4), 8, seed=seed,
                           weight_dist="uniform", high=2**26)
    if kind == "mesh":
        side = max(int(n ** 0.5), 4)
        return grid_mesh(side, "bimodal", heavy_w=10**6, heavy_p=0.1,
                         seed=seed)
    raise ValueError(kind)


def add_query_arguments(ap: argparse.ArgumentParser) -> None:
    """The flags this launcher shares with ``launch/serve.py --mode
    graph-diameter``: the graph family, tau, the cascade, the autotuner,
    the engine mode and the backend."""
    ap.add_argument("--graph", default="road",
                    choices=["road", "social", "mesh"],
                    help="road_like(n), social_like(log2 n) (RMAT) or a "
                         "sqrt(n) x sqrt(n) mesh with bimodal weights")
    ap.add_argument("--tau", type=int, default=None,
                    help="decomposition tau (>= 1); default tau_for(n)")
    ap.add_argument("--levels", type=int, default=0,
                    help="extra quotient-cascade levels (0 = the flat "
                         "pipeline)")
    ap.add_argument("--tau-solve", type=int, default=None,
                    help="cascade solve budget (>= 2): decompose the "
                         "quotient again while it has more clusters; "
                         "default DEFAULT_TAU_SOLVE")
    ap.add_argument("--autotune", default="off",
                    choices=["off", "auto", "record"],
                    help="graph-statistics autotuner (core/autotune.py): "
                         "derive tau/tau-solve/levels/delta-init/fusion/mode "
                         "from one device stats pass; explicit flags stay "
                         "pinned. 'record' persists the tuning cache to JSON")
    # no argparse choices: an unknown name reaches check_engine_mode, so the
    # CLI and the library raise the same ValueError
    ap.add_argument("--engine-mode", default="stages",
                    help="decomposition mode: 'stages' (paper stage loop, "
                         "default), 'oneshot' (exponential-shift single "
                         "fixpoint) or 'auto' (the autotuning record's "
                         "choice; 'stages' without one)")
    ap.add_argument("--deterministic", action="store_true",
                    help="oneshot mode: hash-derived centers and shifts")
    ap.add_argument("--backend", default="kernel",
                    choices=["single", "kernel"])
    ap.add_argument("--device", default="cuda")


def add_telemetry_argument(ap: argparse.ArgumentParser) -> None:
    """The shared ``--telemetry-out`` flag (also ``launch/serve.py``'s)."""
    ap.add_argument("--telemetry-out", default=None, metavar="DIR",
                    help="write a span trace (trace.json, loads in "
                         "ui.perfetto.dev), spans.jsonl and metrics.prom "
                         "under DIR. Tracing adds no host read: the "
                         "measured/counted read equalities hold with it on")


def check_query_arguments(ap: argparse.ArgumentParser, args) -> None:
    """Refuse bad shared flags before any graph or device work."""
    if args.tau is not None and args.tau < 1:
        ap.error(f"--tau must be >= 1, got {args.tau}")
    if args.levels < 0:
        ap.error(f"--levels must be >= 0, got {args.levels}")
    if args.tau_solve is not None and args.tau_solve < 2:
        ap.error(f"--tau-solve must be >= 2, got {args.tau_solve}")
    check_engine_mode(args.engine_mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.diameter")
    add_query_arguments(ap)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--variant", default="stop", choices=["stop", "complete"])
    ap.add_argument("--delta-init", default="avg",
                    help="initial Δ: avg | min | <int>")
    ap.add_argument("--cluster2", action="store_true",
                    help="decompose with CLUSTER2 (paper Algorithm 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-sssp", action="store_true",
                    help="also run the SSSP competitor (Bellman-Ford from "
                         "a random source) on the same session")
    ap.add_argument("--interval", action="store_true",
                    help="also run the farthest-point lower bound")
    ap.add_argument("--shards", type=int, default=0,
                    help="back the session with a GraphStore of this many "
                         "shards (0 or 1: flat storage unless --compress)")
    ap.add_argument("--compress", action="store_true",
                    help="hold the GraphStore's slabs compressed (exact "
                         "delta codec, unpacked on demand)")
    ap.add_argument("--partition", default="range",
                    choices=["range", "cluster"],
                    help="node relabeling for a sharded backend (cluster = "
                         "locality-aware from a pilot decomposition); the "
                         "port has no sharded backend, so it changes "
                         "nothing here")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the decomposition at every stage boundary "
                         "(preemption-safe: a SIGTERM saves and exits 75)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest stage checkpoint in "
                         "--checkpoint-dir")
    add_telemetry_argument(ap)
    args = ap.parse_args(argv)
    check_query_arguments(ap, args)
    if args.shards < 0:
        ap.error(f"--shards must be >= 0, got {args.shards}")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")

    dev = resolve_device(args.device)
    edges = build_graph(args.graph, args.n, args.seed)
    store = None
    if args.shards > 1 or args.compress:
        store = GraphStore(edges, n_shards=max(args.shards, 1),
                           compress=args.compress, device=dev)
        log.info("GraphStore: %d shards, halo_k=%d; a sharded backend "
                 "would move %d B/superstep of halo vs %d B/superstep of "
                 "full planes; host slabs %d B (raw %d B); the %s backend "
                 "reads the flat device arrays, %d B",
                 store.n_shards, store.halo_k(),
                 store.halo_bytes_per_superstep(),
                 store.fullplane_bytes_per_superstep(),
                 store.resident_bytes(), store.raw_bytes(), args.backend,
                 store.device_bytes())
    if args.partition == "cluster":
        log.info("--partition cluster relabels nodes for a sharded backend "
                 "only; the port has none, so the %s backend keeps the "
                 "identity ordering", args.backend)
    guard = PreemptionGuard() if args.checkpoint_dir else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # --telemetry-out arms the span tracer for the session's lifetime (open,
    # decomposition stages, quotient, solve); without it every span is the
    # shared no-op
    tracer = telemetry.Tracer() if args.telemetry_out else None
    with (telemetry.tracing(tracer) if tracer is not None
          else contextlib.nullcontext()), Timer() as t:
        cfg = GraphEngineConfig(variant=args.variant,
                                delta_init=args.delta_init,
                                use_cluster2=args.cluster2, seed=args.seed,
                                mode=args.engine_mode,
                                deterministic=args.deterministic)
        session = open_session(edges if store is None else None, cfg,
                               tau=args.tau, tau_solve=args.tau_solve,
                               backend=args.backend, device=dev,
                               autotune=args.autotune, store=store,
                               checkpoint_dir=args.checkpoint_dir,
                               resume=args.resume, guard=guard)
        # --levels wins; else a record's cascade depth (the session default)
        levels = args.levels
        if levels == 0 and session.tuning is not None:
            levels = session.tuning.levels
        est = (CascadeEstimator(levels=levels) if levels > 0
               else ClusterQuotientEstimator())
        try:
            with guard if guard is not None else contextlib.nullcontext():
                if args.interval:
                    res = IntervalEstimator(
                        (LowerBoundEstimator(seed=args.seed), est)
                    ).estimate(session)
                    upper = res.estimates[est.name]
                else:
                    upper = est.estimate(session)
                    res = None
        except Preempted as p:
            log.warning("preempted at stage %d; checkpoint durable at %s: "
                        "rerun with --resume to finish byte-identically",
                        p.stage, p.path)
            return EXIT_PREEMPTED
        sssp = (session.estimate(DeltaSteppingEstimator(seed=args.seed))
                if args.compare_sssp else None)
        if dev.type == "cuda":
            # sync: the run's host clock ends when the card is done
            torch.cuda.synchronize(dev)
    pm = upper.pipeline
    out = {
        "graph": args.graph, "n": edges.n_nodes, "edges": edges.n_edges,
        "tau": session.tau, "backend": args.backend, "device": str(dev),
        "engine_mode": session.cfg.mode, "cluster2": args.cluster2,
        "phi_approx": upper.phi_approx, "radius": upper.radius,
        "clusters": upper.n_clusters, "quotient_edges": pm.n_quotient_edges,
        "stages": upper.n_stages, "supersteps": upper.growing_steps,
        "solve_supersteps": pm.solve_supersteps,
        "host_syncs": pm.total_host_syncs,
        "checkpoint_syncs": pm.checkpoint_syncs,
        "kernel_launches": pm.kernel_launches, "seconds": t.seconds,
    }
    if store is not None:
        out["store"] = {
            "shards": store.n_shards, "compress": store.compress,
            "halo_k": store.halo_k(),
            "halo_bytes_per_superstep": store.halo_bytes_per_superstep(),
            "fullplane_bytes_per_superstep":
                store.fullplane_bytes_per_superstep(),
            "host_slab_bytes": store.resident_bytes(),
            "raw_bytes": store.raw_bytes(),
            "decompressions": store.decompressions,
            "device_edge_bytes": store.device_bytes()}
    if session.checkpointer is not None:
        ck = session.checkpointer
        out["checkpoint"] = {"saves": ck.saves, "restores": ck.restores,
                             "save_seconds": ck.save_seconds}
    if session.tuning is not None:
        out["tuning"] = dataclasses.asdict(session.tuning)
    if levels > 0:
        out.update(tau_solve=session.tau_solve,
                   cascade_levels=pm.cascade_levels,
                   level_clusters=pm.level_clusters,
                   level_supersteps=pm.level_supersteps,
                   level_syncs=pm.level_syncs)
    if res is not None:
        out.update(lower=res.lower, upper=res.upper, connected=res.connected)
    if sssp is not None:
        out.update(sssp_lower=sssp.lower, sssp_upper=sssp.upper,
                   sssp_supersteps=sssp.growing_steps,
                   sssp_host_syncs=sssp.pipeline.total_host_syncs,
                   round_ratio=sssp.growing_steps
                   / max(upper.growing_steps, 1))
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if tracer is not None:
        registry = telemetry.MetricsRegistry()
        registry.ingest(pm, "pipeline")
        registry.ingest(session.metrics, "session")
        written = telemetry.write_telemetry(args.telemetry_out, tracer,
                                            registry)
        log.info("telemetry: %d spans, %d measured transfers attributed "
                 "-> %s", len(tracer.spans), tracer.total_transfers(),
                 sorted(written.values()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Diameter launcher: the paper pipeline on a resident ``GraphSession``.

  PYTHONPATH=src python -m repro_torch.launch.diameter --graph road \
      --n 200000 --tau 16 --backend kernel [--interval] [--device cuda] \
      [--engine-mode stages|oneshot|auto] [--deterministic] [--cluster2] \
      [--levels L --tau-solve T] [--delta-init avg|min|<int>] \
      [--compare-sssp] [--autotune off|auto|record]

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
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from repro_torch.common import GraphEngineConfig, Timer, resolve_device
from repro_torch.core import (CascadeEstimator, ClusterQuotientEstimator,
                              DeltaSteppingEstimator, IntervalEstimator,
                              LowerBoundEstimator, check_engine_mode,
                              open_session)
from repro_torch.graph import grid_mesh, road_like, social_like


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
    args = ap.parse_args(argv)
    check_query_arguments(ap, args)

    dev = resolve_device(args.device)
    edges = build_graph(args.graph, args.n, args.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with Timer() as t:
        cfg = GraphEngineConfig(variant=args.variant,
                                delta_init=args.delta_init,
                                use_cluster2=args.cluster2, seed=args.seed,
                                mode=args.engine_mode,
                                deterministic=args.deterministic)
        session = open_session(edges, cfg, tau=args.tau,
                               tau_solve=args.tau_solve,
                               backend=args.backend, device=dev,
                               autotune=args.autotune)
        # --levels wins; else a record's cascade depth (the session default)
        levels = args.levels
        if levels == 0 and session.tuning is not None:
            levels = session.tuning.levels
        est = (CascadeEstimator(levels=levels) if levels > 0
               else ClusterQuotientEstimator())
        if args.interval:
            res = IntervalEstimator(
                (LowerBoundEstimator(seed=args.seed), est)).estimate(session)
            upper = res.estimates[est.name]
        else:
            upper = est.estimate(session)
            res = None
        sssp = (session.estimate(DeltaSteppingEstimator(seed=args.seed))
                if args.compare_sssp else None)
        if dev.type == "cuda":
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
        "kernel_launches": pm.kernel_launches, "seconds": t.seconds,
    }
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

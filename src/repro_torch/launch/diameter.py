"""Diameter launcher: the paper pipeline on a resident ``GraphSession``.

  PYTHONPATH=src python -m repro_torch.launch.diameter --graph road \
      --n 200000 --tau 16 --backend kernel [--interval] [--device cuda] \
      [--engine-mode stages|oneshot|auto] [--deterministic]

Prints Phi_approx, the cluster count, quotient size, supersteps, host
reads, kernel launches, seconds and (on CUDA) peak device memory.
``--interval`` adds the farthest-point lower bound and the certified
``[lower, upper]`` bracket from the same session.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.common import GraphEngineConfig, Timer, resolve_device
from repro_torch.core import (ClusterQuotientEstimator, IntervalEstimator,
                              LowerBoundEstimator, check_engine_mode,
                              open_session)
from repro_torch.graph import road_like


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.diameter")
    ap.add_argument("--graph", default="road", choices=["road"],
                    help="graph family: road_like(n)")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--tau", type=int, default=None,
                    help="decomposition tau (>= 1); default tau_for(n)")
    ap.add_argument("--backend", default="kernel",
                    choices=["single", "kernel"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", default="stop", choices=["stop", "complete"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--interval", action="store_true",
                    help="also run the farthest-point lower bound")
    # no argparse choices: an unknown name reaches check_engine_mode, so the
    # CLI and the library raise the same ValueError
    ap.add_argument("--engine-mode", default="stages",
                    help="decomposition mode: 'stages' (paper stage loop, "
                         "default), 'oneshot' (exponential-shift single "
                         "fixpoint) or 'auto' (resolves to 'stages')")
    ap.add_argument("--deterministic", action="store_true",
                    help="oneshot mode: hash-derived centers and shifts")
    args = ap.parse_args(argv)
    if args.tau is not None and args.tau < 1:
        ap.error(f"--tau must be >= 1, got {args.tau}")
    check_engine_mode(args.engine_mode)   # before any graph or device work

    dev = resolve_device(args.device)
    edges = road_like(args.n, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with Timer() as t:
        cfg = GraphEngineConfig(mode=args.engine_mode,
                                deterministic=args.deterministic)
        session = open_session(edges, cfg, tau=args.tau, backend=args.backend,
                               device=dev)
        est = ClusterQuotientEstimator(variant=args.variant, seed=args.seed)
        if args.interval:
            res = IntervalEstimator(
                (LowerBoundEstimator(seed=args.seed), est)).estimate(session)
            upper = res.estimates["cluster-quotient"]
        else:
            upper = est.estimate(session)
            res = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pm = upper.pipeline
    out = {
        "graph": args.graph, "n": edges.n_nodes, "edges": edges.n_edges,
        "tau": session.tau, "backend": args.backend, "device": str(dev),
        "engine_mode": session.cfg.mode,
        "phi_approx": upper.phi_approx, "radius": upper.radius,
        "clusters": upper.n_clusters, "quotient_edges": pm.n_quotient_edges,
        "stages": upper.n_stages, "supersteps": upper.growing_steps,
        "solve_supersteps": pm.solve_supersteps,
        "host_syncs": pm.total_host_syncs,
        "kernel_launches": pm.kernel_launches, "seconds": t.seconds,
    }
    if res is not None:
        out.update(lower=res.lower, upper=res.upper, connected=res.connected)
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

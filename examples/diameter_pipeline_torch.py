"""The paper's experiments on the PyTorch port: CLUSTER against SSSP-BF on
the three benchmark graph families, with the stop/complete variants; the
same graphs, seeds and lines as ``diameter_pipeline.py``, on
``repro_torch``.

  PYTHONPATH=src python examples/diameter_pipeline_torch.py [--scale 0.5] \
      [--device cuda] [--backend kernel|single]

Each graph is opened ONCE into a resident ``GraphSession``; every row after
that is another estimator query against the same device buffers, and the
last is the certified [lower, upper] bracket of the full panel. Both
backends give the same decomposition for a fixed seed, so the estimate
column does not depend on ``--backend``.
"""
import argparse
import sys

from repro_torch.common import GraphEngineConfig, Timer
from repro_torch.core import (
    CascadeEstimator,
    ClusterQuotientEstimator,
    DeltaSteppingEstimator,
    IntervalEstimator,
    open_session,
)
from repro_torch.graph import grid_mesh, random_geometric, social_like


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="kernel", choices=["single", "kernel"])
    args = ap.parse_args(argv)

    graphs = {
        "road-like": random_geometric(int(20_000 * args.scale), 3.0, seed=1),
        "social-like": social_like(12, 8, seed=2, weight_dist="uniform",
                                   high=2**26),
        "mesh-bimodal": grid_mesh(int(48 * max(args.scale, 0.3)), "bimodal",
                                  heavy_w=10**6, heavy_p=0.1, seed=3),
    }
    print(f"{'graph':14s} {'algo':10s} {'estimate':>12s} {'rounds':>7s} "
          f"{'sec':>6s}")
    for name, g in graphs.items():
        with open_session(g, GraphEngineConfig(backend=args.backend),
                          device=args.device) as sess:
            for variant in ("stop", "complete"):
                with Timer() as t:
                    est = sess.estimate(
                        ClusterQuotientEstimator(variant=variant))
                print(f"{name:14s} CL-{variant:8s} {est.phi_approx:12d} "
                      f"{est.growing_steps:7d} {t.seconds:6.1f}")
            with Timer() as t:
                casc = sess.estimate(CascadeEstimator(levels=2, tau_solve=64))
            print(f"{name:14s} {'cascade-2':10s} {casc.phi_approx:12d} "
                  f"{casc.growing_steps:7d} {t.seconds:6.1f}")
            with Timer() as t:
                sssp = sess.estimate(DeltaSteppingEstimator())
            print(f"{name:14s} {'SSSP-BF':10s} {sssp.phi_approx:12d} "
                  f"{sssp.growing_steps:7d} {t.seconds:6.1f}")
            iv = sess.estimate(IntervalEstimator())
            print(f"{name:14s} {'interval':10s} "
                  f"[{iv.lower}, {iv.upper}] connected={iv.connected} "
                  f"({sess.metrics.queries} queries, "
                  f"{sess.metrics.edge_uploads} upload)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

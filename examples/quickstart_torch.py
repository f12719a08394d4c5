"""Quickstart on the PyTorch port: the paper's technique in 30 lines.

Builds a weighted graph, decomposes it with CLUSTER(G, tau), and estimates
the weighted diameter from the quotient graph, then checks against the
exact answer. The same graph, seeds and lines as ``quickstart.py``, on
``repro_torch`` (the CUDA kernels on the card; ``--device cpu`` runs the
plain PyTorch path).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda] \
      [--backend kernel|single]
"""
import argparse
import sys

from scipy.sparse.csgraph import shortest_path

from repro_torch.common import GraphEngineConfig
from repro_torch.core import cluster, open_session
from repro_torch.graph import grid_mesh, to_scipy_csr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="kernel", choices=["single", "kernel"])
    args = ap.parse_args(argv)

    # A 64x64 mesh with bimodal weights (the paper's Delta-sensitivity
    # topology)
    g = grid_mesh(64, "bimodal", heavy_w=10**6, heavy_p=0.1, seed=0)
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} directed edges")

    # the paper's decomposition: clusters of bounded weighted radius
    dec = cluster(g, tau=32, variant="stop", seed=0, backend=args.backend,
                  device=args.device)
    print(f"CLUSTER: {dec.n_clusters} clusters, radius {dec.radius}, "
          f"{dec.growing_steps} Delta-growing steps ({dec.n_stages} stages)")

    # diameter from the quotient graph (open the graph once, then query)
    est = open_session(g, GraphEngineConfig(backend=args.backend),
                       device=args.device).estimate()
    true_phi = int(shortest_path(to_scipy_csr(g), method="D",
                                 directed=False).max())
    print(f"Phi_approx = {est.phi_approx}  vs true {true_phi}  "
          f"(ratio {est.phi_approx / true_phi:.3f}, conservative: "
          f"{est.phi_approx >= true_phi})")
    return 0 if est.phi_approx >= true_phi else 1


if __name__ == "__main__":
    sys.exit(main())

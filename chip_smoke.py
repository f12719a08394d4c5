#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Builds the hand-written CUDA kernel from the checkout's sources, then:

  1. kernel vs plain: ``edge_relax`` on random graphs (n = 1, 257, 10,000,
     1,000,000), an RMAT graph (hub skew), weights up to 7 and 2^30 - 1,
     random Δ, covered nodes with negative offsets and INF/BIG sentinels,
     and at the main path's shapes (the n = 1,890,815 road graph). Every
     comparison is exact equality (all planes are int32).
  2. the main path at the size of the DIMACS CAL road graph:
     ``road_like(1_890_815)`` through ``open_session(backend="kernel",
     tau=16)`` + ``ClusterQuotientEstimator``; the kernel's launch count
     must be > 0; the same query on ``backend="single"`` (plain PyTorch on
     the card) must give byte-identical final planes and an equal Phi.
  3. certified bracket: ``IntervalEstimator`` on ``road_like(65_536)``
     (lower <= upper) and on ``road_like(4_096)`` (lower <= scipy exact <=
     upper).

Prints one JSON line per phase, the kernel table, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INF, BIG = 2**31 - 1, 2**30
CAL_NODES = 1_890_815           # DIMACS 9th Challenge USA-road-d.CAL


def _fail(msg: str, code: int) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return code


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_planes(n: int, wmax: int, seed: int, covered_frac=0.3,
                  live_frac=0.3):
    """Engine-like node planes: live nodes (d < 2 wmax), covered relays with
    negative offsets, INF/BIG sentinels elsewhere."""
    r = np.random.default_rng(seed)
    d = np.full(n, INF, np.int32)
    live = r.random(n) < live_frac
    d[live] = r.integers(0, min(2 * wmax, BIG), live.sum())
    c = np.full(n, INF, np.int32)
    c[live] = r.integers(0, max(n, 1), live.sum())
    p = np.full(n, INF, np.int32)
    p[live] = d[live]
    rw0 = np.full(n, BIG, np.int32)
    cov = (r.random(n) < covered_frac) & ~live
    rw0[cov] = r.integers(-wmax, 1, cov.sum())
    rc = np.full(n, INF, np.int32)
    rc[cov] = r.integers(0, max(n, 1), cov.sum())
    rp = np.full(n, INF, np.int32)
    rp[cov] = r.integers(0, min(4 * wmax, BIG), cov.sum())
    return d, c, p, rw0, rc, rp


def relax_bytes(torch, g, planes, delta) -> int:
    """Least bytes this superstep must move on these inputs: the CSR
    (row_ptr, src, w) and d, rw0 read once; c, pathw read once for the
    sources of admissible live edges and rc, rp for those of admissible
    relay edges; three output planes written once."""
    d, rw0 = planes[0], planes[3]
    src = g.src.to(torch.int64)
    ds, r0 = d[src], rw0[src]
    live = (ds < delta) & (g.w < delta)
    w_red = torch.clamp_min(g.w + torch.clamp_max(r0, BIG), 0)
    relay = (r0 < BIG) & (w_red < delta)
    n = g.n_nodes
    n_live = int(torch.unique(g.src[live & ~relay]).numel())
    n_relay = int(torch.unique(g.src[relay]).numel())
    return (4 * (n + 1) + 8 * g.n_edges + 8 * n + 8 * n_live + 8 * n_relay
            + 12 * n)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False; this script "
                     "measures the CUDA port and has no CPU mode", 2)
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels").is_dir():
        return _fail(f"no src/repro_torch beside {__file__}; run it from a "
                     "checkout of the repository", 3)
    sys.path.insert(0, str(root / "src"))

    from scipy.sparse.csgraph import shortest_path

    from repro_torch.common import Timer
    from repro_torch.core import (ClusterQuotientEstimator, IntervalEstimator,
                                  open_session)
    from repro_torch.graph import road_like, social_like, to_scipy_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel as kmod
    from repro_torch.kernels.edge_relax.ops import (build_relax_graph,
                                                    edge_relax,
                                                    edge_relax_plain)

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # -- build --------------------------------------------------------------
    with Timer() as t:
        kmod.load_library()
    log = _build.library_path(kmod.NAME, kmod.SOURCES).with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "kernel": "edge_relax", "seconds": t.seconds,
          "ptxas": ptxas})

    # -- phase 1: kernel vs plain --------------------------------------------
    max_err = 0

    def compare(name, g, planes_np, delta, iters=0):
        nonlocal max_err
        tp = [torch.from_numpy(x).to(dev) for x in planes_np]
        out = edge_relax(tp, g, delta)
        ref = edge_relax_plain(tp, g, delta)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  if a.numel() else 0 for a, b in zip(out, ref))
        max_err = max(max_err, err)
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"edge_relax {name}: kernel != plain "
                                 f"(max abs err {err})")
        row = {"phase": "kernel_vs_plain", "case": name, "n": g.n_nodes,
               "edges": g.n_edges, "delta": int(delta), "equal": True}
        if iters:
            row["ms"] = time_ms(torch, lambda: edge_relax(tp, g, delta), iters)
            row["plain_ms"] = time_ms(
                torch, lambda: edge_relax_plain(tp, g, delta), max(iters // 4, 2))
            row["bound_ms"] = (relax_bytes(torch, g, tp, delta)
                               / HBM_BYTES_PER_S * 1e3)
        emit(row)
        return row

    rng = np.random.default_rng(0)
    for n in (1, 257, 10_000, 1_000_000):
        for wmax in (7, 2**30 - 1):
            e = max(6 * n, 3)
            src = rng.integers(0, n, e).astype(np.int32)
            dst = rng.integers(0, max(n - n // 50, 1), e).astype(np.int32)
            w = rng.integers(1, wmax + 1, e).astype(np.int32)
            g = build_relax_graph(src, dst, w, n, dev)
            delta = int(rng.integers(1, min(2 * wmax, BIG) + 1))
            compare(f"random n={n} wmax={wmax}", g,
                    random_planes(n, wmax, seed=n + wmax), delta,
                    iters=20 if n == 1_000_000 and wmax == 7 else 0)
    social = social_like(20, seed=0)
    g = build_relax_graph(social.src, social.dst, social.weight,
                          social.n_nodes, dev)
    wmax = int(social.weight.max())
    compare("rmat social_like(20)", g,
            random_planes(social.n_nodes, wmax, seed=1),
            int(rng.integers(1, 2 * wmax)), iters=10)
    del g, social

    # -- phase 2: the main path at the CAL road graph's size ------------------
    with Timer() as t:
        edges = road_like(CAL_NODES, seed=0)
    emit({"phase": "graph", "family": "road_like", "n": edges.n_nodes,
          "edges": edges.n_edges, "seconds": t.seconds})

    def run_main(backend: str):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kmod.edge_relax_cuda.launches = 0
        with Timer() as tt:
            session = open_session(edges, backend=backend, tau=16, device=dev)
            res = session.estimate(ClusterQuotientEstimator())
            torch.cuda.synchronize()
        launches = kmod.edge_relax_cuda.launches
        pm = res.pipeline
        if launches != pm.kernel_launches:
            raise AssertionError(f"{backend}: wrapper counted {launches} "
                                 f"launches, the backend {pm.kernel_launches}")
        row = {"phase": "main_path", "backend": backend, "n": edges.n_nodes,
               "edges": edges.n_edges, "tau": 16, "phi_approx": res.phi_approx,
               "radius": res.radius, "clusters": res.n_clusters,
               "quotient_edges": pm.n_quotient_edges,
               "stages": res.n_stages, "supersteps": res.growing_steps,
               "solve_supersteps": pm.solve_supersteps,
               "solve_dtype": "int64" if pm.solve_int64 else "int32",
               "kernel_launches": launches,
               "host_syncs": pm.total_host_syncs,
               "decompose_syncs": pm.decompose_syncs,
               "solve_syncs": pm.solve_syncs,
               "seconds": tt.seconds,
               "decompose_seconds": pm.decompose_seconds,
               "quotient_seconds": pm.quotient_seconds,
               "solve_seconds": pm.solve_seconds,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "connected": res.connected}
        emit(row)
        graph = session.backend.graph if backend == "kernel" else None
        session.close()
        return res, row, launches, graph

    res_k, row_k, launches, road_graph = run_main("kernel")
    if launches <= 0:
        raise AssertionError("main path ran without launching edge_relax")
    if launches < row_k["supersteps"]:
        raise AssertionError("fewer kernel launches than supersteps")
    res_s, row_s, launches_s, _ = run_main("single")
    if launches_s != 0:
        raise AssertionError("the plain backend launched the kernel")
    dk, ds = res_k.decomposition, res_s.decomposition
    if not (np.array_equal(dk.final_c, ds.final_c)
            and np.array_equal(dk.final_pathw, ds.final_pathw)):
        raise AssertionError("kernel and plain backends decomposed differently")
    if res_k.phi_approx != res_s.phi_approx or not res_k.connected:
        raise AssertionError(f"Phi differs: kernel {res_k.phi_approx} vs "
                             f"plain {res_s.phi_approx}")
    fc = dk.final_c
    if fc.shape != (edges.n_nodes,) or not (fc[fc] == fc).all() \
            or int(dk.final_pathw.max()) != res_k.radius:
        raise AssertionError("decomposition planes are malformed")
    emit({"phase": "main_path_parity", "byte_identical": True,
          "phi_approx": res_k.phi_approx})

    # the kernel at the main path's shapes: the road graph's CSR with
    # engine-like planes and the run's final Δ
    main_row = compare("main path road_like(1890815)", road_graph,
                       random_planes(edges.n_nodes, int(edges.weight.max()),
                                     seed=2), res_k.delta_end, iters=50)
    del road_graph, edges

    # -- phase 3: certified bracket ------------------------------------------
    for n, check_exact in ((65_536, False), (4_096, True)):
        e = road_like(n, seed=0)
        with Timer() as tt:
            iv = IntervalEstimator().estimate(open_session(e, device=dev))
        row = {"phase": "interval", "n": n, "lower": iv.lower,
               "upper": iv.upper, "connected": iv.connected,
               "host_syncs": iv.pipeline.total_host_syncs,
               "seconds": tt.seconds}
        if not iv.lower <= iv.upper:
            raise AssertionError(f"bracket violated at n={n}")
        if check_exact:
            exact = int(shortest_path(to_scipy_csr(e), method="D",
                                      directed=False).max())
            row["scipy_exact"] = exact
            if not iv.lower <= exact <= iv.upper:
                raise AssertionError(f"scipy exact {exact} outside "
                                     f"[{iv.lower}, {iv.upper}]")
        emit(row)

    emit({"kernels": [{
        "name": "edge_relax", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/kernel.py:78",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The paper's competitor in the port against the JAX package: Δ-stepping
(distances AND the reference's superstep accounting, one gated superstep
in place of its two nested loops), the all-sources Bellman-Ford, the
2-approximation from one source, and ``DeltaSteppingEstimator`` on a
resident session, each byte-identical to the reference on the CPU; the
launcher's ``--compare-sssp`` and ``--graph social|mesh``. Every array is
an integer, so every comparison is exact."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import json

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import DeltaSteppingEstimator as RefDS  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.core import sssp as ref_sssp  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.core import (DeltaSteppingEstimator,  # noqa: E402
                              DiameterEstimator, open_session, sssp)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.launch import diameter as launcher  # noqa: E402


GRAPHS = {
    "road_like(4096)": lambda g: g.road_like(4096, seed=0),
    "social_like(10)": lambda g: g.social_like(10, seed=0),
    "grid_mesh(30)": lambda g: g.grid_mesh(30, "bimodal", heavy_w=10**6,
                                           heavy_p=0.1, seed=0),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    make = GRAPHS[request.param]
    return make(ref_gen), make(gen)


def _pair(n, src, dst, w):
    return (RefEdgeList(n, np.asarray(src), np.asarray(dst), np.asarray(w)),
            EdgeList(n, np.asarray(src), np.asarray(dst), np.asarray(w)))


def _assert_same(got, want):
    assert got.supersteps == want.supersteps
    assert got.inf == want.inf
    assert got.dist.dtype == want.dist.dtype
    np.testing.assert_array_equal(got.dist, want.dist)


@pytest.mark.parametrize("delta_kind", ["one", "mean", "above_max"])
def test_delta_stepping_matches_reference(graph, delta_kind):
    ref_e, e = graph
    delta = {"one": 1, "mean": max(int(e.weight.mean()), 1),
             "above_max": int(e.weight.max()) + 1}[delta_kind]
    want = ref_sssp.delta_stepping(ref_e, 3, delta)
    got = sssp.delta_stepping(e, 3, delta, device="cpu")
    _assert_same(got, want)
    assert got.syncs >= 2   # a chunk read and the plane


def test_delta_stepping_is_chunk_independent():
    e = gen.road_like(1000, seed=3)
    delta = max(int(e.weight.mean()), 1)
    runs = [sssp.delta_stepping(e, 0, delta, device="cpu", chunk=c)
            for c in (1, 3, 8, 64)]
    for r in runs[1:]:
        _assert_same(r, runs[0])
    # one read per chunk of gated supersteps plus the plane: fewer reads
    # with a longer chunk
    assert runs[0].syncs > runs[1].syncs > runs[2].syncs >= runs[3].syncs


def test_delta_stepping_jumps_over_empty_buckets():
    """A path of heavy edges at Δ = 1: almost every bucket is empty, and the
    walk jumps straight to the next occupied one (a bucket costs its light
    pass, none of the empty ones between)."""
    n = 40
    u = np.arange(n - 1)
    w = np.full(n - 1, 1000)
    w[::7] = 3
    ref_e, e = _pair(n, np.r_[u, u + 1], np.r_[u + 1, u], np.r_[w, w])
    want = ref_sssp.delta_stepping(ref_e, 0, 1)
    got = sssp.delta_stepping(e, 0, 1, device="cpu")
    _assert_same(got, want)
    # every edge is heavy at Δ = 1: each occupied bucket costs its (empty)
    # light pass and its heavy pass, the ~33,000 empty ones nothing
    assert got.supersteps == 2 * n < int(got.dist.max())


def test_delta_stepping_int64_distances():
    """Weights near 2^30: ``n * wmax`` overflows int32, so the loop runs in
    int64 with the reference's sentinel."""
    r = np.random.default_rng(1)
    n, m = 60, 240
    src, dst = r.integers(0, n, m), r.integers(0, n, m)
    w = r.integers(2**29, 2**30 - 1, m)
    ref_e, e = _pair(n, np.r_[src, dst], np.r_[dst, src], np.r_[w, w])
    for delta in (1, 2**29, 2**30):
        want = ref_sssp.delta_stepping(ref_e, 5, delta)
        got = sssp.delta_stepping(e, 5, delta, device="cpu")
        assert got.dist.dtype == np.int64 and got.inf == sssp.INF64
        _assert_same(got, want)


def test_delta_stepping_disconnected_and_tiny_graphs():
    # two components: the unreached keep the sentinel
    ref_e, e = _pair(6, [0, 1, 3, 4], [1, 0, 4, 3], [5, 5, 2, 2])
    for delta in (1, 3, 100):
        want = ref_sssp.delta_stepping(ref_e, 0, delta)
        got = sssp.delta_stepping(e, 0, delta, device="cpu")
        _assert_same(got, want)
        assert (got.dist[2:] == got.inf).all()
    z = np.zeros(0, np.int64)
    ref_e, e = _pair(1, z, z, z)
    _assert_same(sssp.delta_stepping(e, 0, 4, device="cpu"),
                 ref_sssp.delta_stepping(ref_e, 0, 4))
    # n = 0: the reference's source write raises; the port returns the
    # empty plane after no superstep (the estimators' degenerate case)
    ref_e, e = _pair(0, z, z, z)
    with pytest.raises(IndexError):
        ref_sssp.delta_stepping(ref_e, 0, 4)
    got = sssp.delta_stepping(e, 0, 4, device="cpu")
    assert got.dist.shape == (0,) and got.supersteps == 0
    with pytest.raises(ValueError, match="delta"):
        sssp.delta_stepping(e, 0, 0, device="cpu")


def test_bellman_ford_and_delta_stepping_agree(graph):
    _, e = graph
    bf = sssp.bellman_ford(e, 11, device="cpu")
    ds = sssp.delta_stepping(e, 11, max(int(e.weight.mean()), 1),
                             device="cpu")
    np.testing.assert_array_equal(bf.dist, ds.dist)


def test_multi_source_bellman_ford_matches_reference(graph):
    ref_e, e = graph
    sources = [0, 5, 17, 5, e.n_nodes - 1]
    want = ref_sssp.multi_source_bellman_ford(ref_e, sources)
    got = sssp.multi_source_bellman_ford(e, sources, device="cpu", chunk=5)
    assert (got.supersteps, got.connected) == (want.supersteps,
                                               want.connected)
    assert got.dist.shape == (len(sources), e.n_nodes)
    np.testing.assert_array_equal(got.dist, want.dist)
    assert got.syncs == -(-(got.supersteps + 1) // 5) + 1


def test_multi_source_bellman_ford_disconnected():
    ref_e, e = _pair(5, [0, 1, 3], [1, 0, 4], [2, 2, 7])
    want = ref_sssp.multi_source_bellman_ford(ref_e, [0, 3])
    got = sssp.multi_source_bellman_ford(e, [0, 3], device="cpu")
    assert not got.connected and not want.connected
    np.testing.assert_array_equal(got.dist, want.dist)


@pytest.mark.parametrize("seed", [0, 7])
def test_diameter_2approx_matches_reference(graph, seed):
    ref_e, e = graph
    assert sssp.diameter_2approx_sssp(e, seed, device="cpu") == \
        ref_sssp.diameter_2approx_sssp(ref_e, seed)


def test_diameter_2approx_degenerate():
    z = np.zeros(0, np.int64)
    ref_e, e = _pair(0, z, z, z)
    assert sssp.diameter_2approx_sssp(e, device="cpu") == (0, 0, 0, True)
    ref_e, e = _pair(4, [0, 1], [1, 0], [3, 3])
    assert sssp.diameter_2approx_sssp(e, 2, device="cpu") == \
        ref_sssp.diameter_2approx_sssp(ref_e, 2)


FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
          "growing_steps", "n_stages", "delta_end", "connected", "method",
          "lower", "upper")


@pytest.mark.parametrize("delta", [None, "mean"])
@pytest.mark.parametrize("backend", ["kernel", "single"])
def test_delta_stepping_estimator_matches_reference(graph, delta, backend):
    ref_e, e = graph
    if delta == "mean":
        delta = max(int(e.weight.mean()), 1)
    want = ref_open_session(ref_e).estimate(RefDS(seed=7, delta=delta))
    session = open_session(e, backend=backend, device="cpu")
    with guard.metered() as meter:
        got = session.estimate(DeltaSteppingEstimator(seed=7, delta=delta))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    pm = got.pipeline
    assert pm.solve_supersteps == want.pipeline.solve_supersteps
    # the port reads once per chunk of 8 gated supersteps, plus the plane
    assert pm.total_host_syncs == pm.solve_syncs == meter.transfers >= 2
    assert got.dist.shape == (e.n_nodes,) and got.lower in got.dist


def test_delta_stepping_estimator_edge_cases():
    z = np.zeros(0, np.int64)
    for n in (0, 1):
        est = open_session(EdgeList(n, z, z, z), device="cpu").estimate(
            DeltaSteppingEstimator())
        assert (est.lower, est.upper, est.connected) == (0, 0, True)
    # disconnected: ecc stays a lower bound, there is no certified upper
    ref_e, e = _pair(5, [0, 1, 3], [1, 0, 4], [2, 2, 7])
    want = ref_open_session(ref_e).estimate(RefDS(seed=1, delta=2))
    got = open_session(e, device="cpu").estimate(
        DeltaSteppingEstimator(seed=1, delta=2))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.upper is None and not got.connected
    with pytest.raises(ValueError, match="delta"):
        open_session(e, device="cpu").estimate(DeltaSteppingEstimator(
            delta=0))
    assert isinstance(DeltaSteppingEstimator(), DiameterEstimator)


@pytest.mark.parametrize("graph_kind,n", [("road", 3000), ("social", 2048),
                                          ("mesh", 900)])
def test_launcher_compare_sssp(capsys, graph_kind, n):
    assert launcher.main(["--graph", graph_kind, "--n", str(n), "--device",
                          "cpu", "--compare-sssp"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = ref_sssp.diameter_2approx_sssp(
        launcher.build_graph(graph_kind, n, 0), 0)
    assert out["graph"] == graph_kind
    assert (out["sssp_lower"], out["sssp_upper"],
            out["sssp_supersteps"]) == want[:3]
    assert out["sssp_lower"] <= out["phi_approx"]
    assert out["round_ratio"] == out["sssp_supersteps"] / max(
        out["supersteps"], 1)

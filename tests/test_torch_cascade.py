"""The quotient cascade in the port against the JAX package: level 0 is
the flat pipeline field for field; at ``levels=2, tau_solve=32`` Phi, the
per-level cluster counts and supersteps and the solve's supersteps equal
the reference's in stages and deterministic one-shot level modes; the
level layout (``quotient_as_edgelist``: ``e_pad``, inert self-loops,
ceiling rescale) and the next level's quotient are the reference's arrays;
the min-plus oracle equals scipy's; degenerate graphs; the launcher's
``--levels``/``--tau-solve``. Every array is an integer, so every
comparison is exact. No case here hits the one-ulp float32 ``log``
difference of the one-shot shifts, so no start plane is injected."""
import contextlib
import dataclasses
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    @contextlib.contextmanager
    def _enable_x64(new_val: bool = True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = _enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.sparse.csgraph import shortest_path  # noqa: E402

from repro.config.base import GraphEngineConfig as RefCfg  # noqa: E402
from repro.core import CascadeEstimator as RefCascade  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.core import quotient as ref_q  # noqa: E402
from repro.core.backend import SingleDeviceBackend as RefSingle  # noqa: E402
from repro.core.backend import make_backend as ref_make_backend  # noqa: E402
from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.core.engine import run_cluster as ref_run_cluster  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.core import (DEFAULT_TAU_SOLVE,  # noqa: E402
                              CascadeEstimator, ClusterQuotientEstimator,
                              DiameterEstimator, LowerBoundEstimator,
                              SingleDeviceBackend, cluster, cluster2,
                              make_backend, open_session, run_cluster,
                              run_oneshot)
from repro_torch.core import quotient as q  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import (MAX_WEIGHT, EdgeList,  # noqa: E402
                                          to_scipy_csr)
from repro_torch.launch import diameter as launcher  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain path's eager operations are small: one intra-op thread
    each, so that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

GRAPHS = {
    "road_like(2000)": lambda g: g.road_like(2000, seed=0),
    "road_like(8000)": lambda g: g.road_like(8000, seed=0),
    "social_like(10)": lambda g: g.social_like(10, seed=0),
}

# (level-0 mode, deterministic, level_mode)
MODES = {
    "stages": ("stages", False, None),
    "oneshot deterministic": ("oneshot", True, None),
    "stages, oneshot levels": ("stages", True, "oneshot"),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    make = GRAPHS[request.param]
    return make(ref_gen), make(gen)


def _port_edges(ref_e):
    return EdgeList(ref_e.n_nodes, ref_e.src, ref_e.dst, ref_e.weight)


def _exact(e):
    d = shortest_path(to_scipy_csr(e), method="D", directed=False)
    fin = d[np.isfinite(d)]
    return int(fin.max()) if len(fin) else 0


FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
          "growing_steps", "n_stages", "delta_end", "connected", "upper")


def _assert_fields(got, want, fields=FIELDS):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.quotient_ecc, want.quotient_ecc)


@pytest.mark.parametrize("name", ["road_like(2000)", "social_like(10)"])
@pytest.mark.parametrize("backend,fuse", [("single", 0), ("kernel", 0),
                                          ("kernel", 8)])
def test_level0_cascade_field_identical_to_flat(name, backend, fuse):
    e = GRAPHS[name](gen)
    session = open_session(e, GraphEngineConfig(fuse_supersteps=fuse),
                           backend=backend, device="cpu")
    flat = session.estimate(ClusterQuotientEstimator())
    # tau_solve 2: levels=0 never cascades, however large the quotient
    casc = session.estimate(CascadeEstimator(levels=0, tau_solve=2))
    _assert_fields(casc, flat)
    timeless = {k: v for k, v in dataclasses.asdict(flat.pipeline).items()
                if not k.endswith("seconds")}
    assert timeless == {k: v for k, v in dataclasses.asdict(
        casc.pipeline).items() if not k.endswith("seconds")}
    assert casc.method == "cascade" and casc.pipeline.level_clusters == []


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cascade_matches_reference(graph, mode):
    ref_e, e = graph
    engine_mode, det, level_mode = MODES[mode]
    want = ref_open_session(ref_e, RefCfg(
        mode=engine_mode, deterministic=det)).estimate(RefCascade(
            levels=2, tau_solve=32, level_mode=level_mode))
    session = open_session(e, GraphEngineConfig(mode=engine_mode,
                                                deterministic=det),
                           device="cpu")
    with guard.metered() as meter:
        got = session.estimate(CascadeEstimator(levels=2, tau_solve=32,
                                                level_mode=level_mode))
    _assert_fields(got, want)
    pm, rpm = got.pipeline, want.pipeline
    for f in ("cascade_levels", "level_clusters", "level_supersteps",
              "solve_supersteps", "n_quotient_edges"):
        assert getattr(pm, f) == getattr(rpm, f), f
    assert pm.cascade_levels >= 1
    assert meter.transfers == pm.total_host_syncs
    assert len(pm.level_syncs) == len(pm.level_seconds) == pm.cascade_levels
    assert sum(pm.level_syncs) < pm.total_host_syncs
    flat = session.estimate(ClusterQuotientEstimator())
    assert got.growing_steps == flat.growing_steps + sum(pm.level_supersteps)
    assert pm.solve_supersteps <= flat.pipeline.solve_supersteps


def _ref_and_port_quotient(ref_e, e, tau):
    """The reference's and the port's level-0 DeviceQuotient of the same
    decomposition (the port's draws equal the reference's)."""
    ref_dec = ref_cluster(ref_e, tau)
    dec = cluster(e, tau, backend="single", device="cpu")
    np.testing.assert_array_equal(dec.final_c, ref_dec.final_c)
    rdq = ref_q.build_quotient_device(ref_e, ref_dec,
                                      backend=ref_make_backend(ref_e,
                                                               "single"))
    dq = q.build_quotient_device(e, dec, make_backend(e, "single",
                                                      device="cpu"))
    return rdq, dq


def _assert_level(lv, rlv):
    assert (lv.n_nodes, lv.n_edges, lv.scale, lv.weight_sum) == (
        rlv.n_nodes, rlv.n_edges, rlv.scale, rlv.weight_sum)
    for f in ("src", "dst", "weight"):
        got, want = getattr(lv, f).numpy(), np.asarray(getattr(rlv, f))
        assert got.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("bucket", [256, 7])
def test_quotient_as_edgelist_matches_reference(graph, bucket):
    ref_e, e = graph
    rdq, dq = _ref_and_port_quotient(ref_e, e, 4)
    counters = q.fetch_quotient_counters(dq)
    assert counters == ref_q.fetch_quotient_counters(rdq)
    lv = q.quotient_as_edgelist(dq, *counters, edge_bucket=bucket)
    rlv = ref_q.quotient_as_edgelist(rdq, *counters, edge_bucket=bucket)
    _assert_level(lv, rlv)
    assert lv.src.shape[0] % bucket == 0 or lv.src.shape[0] == e.n_edges
    # the level's decomposition and its quotient: the reference's arrays
    be = SingleDeviceBackend.from_device(lv.n_nodes, lv.src, lv.dst,
                                         lv.weight)
    dec_l = run_cluster(None, be, 4, seed=1, max_delta=lv.weight_sum + 1)
    rbe = RefSingle.from_device(rlv.n_nodes, rlv.src, rlv.dst, rlv.weight)
    rdec_l = ref_run_cluster(None, rbe, 4, seed=1,
                             max_delta=rlv.weight_sum + 1)
    np.testing.assert_array_equal(dec_l.final_c, rdec_l.final_c)
    np.testing.assert_array_equal(dec_l.final_pathw, rdec_l.final_pathw)
    nq = q.build_quotient_from_level(lv, dec_l)
    rnq = ref_q.build_quotient_from_level(rlv, rdec_l)
    assert q.fetch_quotient_counters(nq) == ref_q.fetch_quotient_counters(rnq)
    k, m = q.fetch_quotient_counters(nq)[:2]
    with jax.experimental.enable_x64():
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(nq, f)[:m].numpy(),
                                          np.asarray(getattr(rnq, f)[:m]))


def _device_quotients(heavy):
    """One hand-built quotient in both packages: three real edges (one of
    int64-only weight), one padding slot."""
    kw = dict(src=[0, 1, 2, 7], dst=[1, 2, 0, 7],
              weight=[heavy, 5, 1, int(q.INF64)])
    with jax.experimental.enable_x64():
        rdq = ref_q.DeviceQuotient(
            centers=jnp.arange(3, dtype=jnp.int32),
            src=jnp.asarray(kw["src"], jnp.int32),
            dst=jnp.asarray(kw["dst"], jnp.int32),
            weight=jnp.asarray(kw["weight"], jnp.int64),
            n_clusters=jnp.int32(3), n_edges=jnp.int32(3),
            max_weight=jnp.int64(heavy), weight_sum=jnp.int64(heavy + 6))
    i64 = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    dq = q.DeviceQuotient(
        centers=torch.arange(3, dtype=torch.int32),
        src=torch.tensor(kw["src"], dtype=torch.int32),
        dst=torch.tensor(kw["dst"], dtype=torch.int32),
        weight=i64(kw["weight"]), n_clusters=i64(3), n_edges=i64(3),
        max_weight=i64(heavy), weight_sum=i64(heavy + 6))
    return rdq, dq


@pytest.mark.parametrize("heavy", [1000, 3 * int(MAX_WEIGHT),
                                   7 * int(MAX_WEIGHT) + 5])
def test_quotient_as_edgelist_rescale_and_padding(heavy):
    rdq, dq = _device_quotients(heavy)
    lv = q.quotient_as_edgelist(dq, 3, 3, heavy, heavy + 6, edge_bucket=4)
    rlv = ref_q.quotient_as_edgelist(rdq, 3, 3, heavy, heavy + 6,
                                     edge_bucket=4)
    _assert_level(lv, rlv)
    assert lv.scale == max(-(-heavy // int(MAX_WEIGHT)), 1)
    # the padding slot is an inert self-loop; the host copy is valid
    assert (int(lv.src[3]), int(lv.dst[3]), int(lv.weight[3])) == (0, 0, 1)
    el = lv.to_edgelist()
    assert (el.n_nodes, el.n_edges) == (3, 3)


def test_cascade_conservative_under_rescale():
    """Weights near 2^30 push quotient sums past int32: some level rescales
    (scale > 1), the result equals the reference's and still bounds the
    exact diameter."""
    ref_e = ref_gen.random_connected(120, 360, seed=4, weight_dist="uniform",
                                     high=2**30 - 1)
    e = _port_edges(ref_e)
    want = ref_open_session(ref_e, tau=4, tau_solve=4).estimate(
        RefCascade(levels=2))
    got = open_session(e, tau=4, tau_solve=4, device="cpu").estimate(
        CascadeEstimator(levels=2))
    _assert_fields(got, want)
    assert got.pipeline.level_clusters == want.pipeline.level_clusters
    assert got.pipeline.cascade_levels >= 1
    assert got.upper >= _exact(e) and got.connected


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_cascade_bound_contract(levels):
    ref_e = ref_gen.random_connected(300, 900, seed=9, weight_dist="uniform",
                                     high=1000)
    e = _port_edges(ref_e)
    sess = open_session(e, tau=4, tau_solve=4, device="cpu")
    lo = sess.estimate(LowerBoundEstimator(rounds=3, seed=0))
    up = sess.estimate(CascadeEstimator(levels=levels))
    assert lo.lower <= _exact(e) <= up.upper
    assert up.phi_approx == up.phi_quotient + 2 * up.radius
    assert (up.pipeline.cascade_levels >= 1) == (levels > 0)


def _quotient_graph(n, src, dst, w):
    return q.QuotientGraph(n, np.arange(n), np.asarray(src, np.int32),
                           np.asarray(dst, np.int32),
                           np.asarray(w, np.int64))


def test_minplus_oracle_matches_scipy(graph):
    ref_e, e = graph
    # CLUSTER2's coarse quotient (tens of clusters): min-plus is cubic in k
    dec = cluster2(e, 4, backend="single", device="cpu")
    qg = q.build_quotient_numpy(e, dec)
    assert q.quotient_diameter_minplus(qg) == q.quotient_diameter(qg)
    rqg = ref_q.QuotientGraph(qg.n_clusters, qg.center_ids, qg.src, qg.dst,
                              qg.weight)
    assert q.quotient_diameter_minplus(qg) == \
        ref_q.quotient_diameter_minplus(rqg)


def test_minplus_oracle_edge_cases():
    # weights past 2^24 stay exact (float32 would round them)
    big = _quotient_graph(4, [0, 1, 2], [1, 2, 3],
                          [2**40 + 1, 2**33 + 3, 7])
    assert q.quotient_diameter_minplus(big) == (2**40 + 2**33 + 11, True)
    disc = _quotient_graph(4, [0, 2], [1, 3], [5, 9])
    assert q.quotient_diameter_minplus(disc) == (9, False)
    assert q.quotient_diameter_minplus(disc) == q.quotient_diameter(disc)
    assert q.quotient_diameter_minplus(_quotient_graph(1, [], [], [])) == \
        (0, True)


def _edgeless(n):
    z = np.zeros(0, np.int32)
    return EdgeList(n, z, z, z)


def test_cascade_degenerate_graphs():
    for n in (0, 1):
        est = open_session(_edgeless(n), tau=2, device="cpu").estimate(
            CascadeEstimator(levels=2, tau_solve=2))
        assert est.phi_approx == 0 and est.connected
    est = open_session(_edgeless(5), tau=2, device="cpu").estimate(
        CascadeEstimator(levels=2, tau_solve=2))
    assert not est.connected
    # two triangles: every level keeps the components apart
    u = np.array([0, 1, 2, 3, 4, 5], np.int32)
    v = np.array([1, 2, 0, 4, 5, 3], np.int32)
    g = EdgeList.from_undirected(6, u, v, np.ones(6, np.int32))
    rg = RefEdgeList.from_undirected(6, u, v, np.ones(6, np.int32))
    got = open_session(g, tau=2, device="cpu").estimate(
        CascadeEstimator(levels=2, tau_solve=2))
    want = ref_open_session(rg, tau=2).estimate(
        RefCascade(levels=2, tau_solve=2))
    assert not got.connected and got.phi_approx >= 1
    _assert_fields(got, want)


def test_cascade_validation_and_protocol():
    g = gen.grid_mesh(4, "unit")
    sess = open_session(g, device="cpu")
    assert sess.tau_solve == DEFAULT_TAU_SOLVE == 1024
    assert open_session(g, tau_solve=2, device="cpu").tau_solve == 2
    with pytest.raises(ValueError, match="levels"):
        sess.estimate(CascadeEstimator(levels=-1))
    with pytest.raises(ValueError, match="tau_solve"):
        sess.estimate(CascadeEstimator(tau_solve=1))
    with pytest.raises(ValueError, match="tau_solve"):
        open_session(g, tau_solve=0, device="cpu")
    assert isinstance(CascadeEstimator(), DiameterEstimator)


def test_engine_on_device_edges_needs_max_delta():
    e = gen.road_like(300, seed=0)
    be = SingleDeviceBackend(e, device="cpu")
    for run in (run_cluster, run_oneshot):
        with pytest.raises(ValueError, match="max_delta"):
            run(None, be, 4)
    # with edges=None the node count comes from the backend
    src, dst, w = be.flat_edges()
    dev_be = SingleDeviceBackend.from_device(e.n_nodes, src, dst, w)
    wsum = int(e.weight.astype(np.int64).sum())
    a = run_cluster(None, dev_be, 4, max_delta=wsum + 1)
    b = run_cluster(e, SingleDeviceBackend(e, device="cpu"), 4)
    np.testing.assert_array_equal(a.final_c, b.final_c)
    assert a.n_nodes == e.n_nodes and dev_be.device == src.device


def test_launcher_levels(capsys):
    assert launcher.main(["--graph", "road", "--n", "4000", "--device", "cpu",
                          "--levels", "2", "--tau-solve", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = ref_open_session(ref_gen.road_like(4000, seed=0),
                            tau_solve=32).estimate(RefCascade(levels=2))
    assert (out["phi_approx"], out["level_clusters"], out["solve_supersteps"]
            ) == (want.phi_approx, want.pipeline.level_clusters,
                  want.pipeline.solve_supersteps)
    assert out["tau_solve"] == 32 and out["cascade_levels"] >= 1


def test_launcher_all_new_flags(capsys):
    assert launcher.main(["--graph", "road", "--n", "4000", "--device", "cpu",
                          "--compare-sssp", "--cluster2", "--levels", "2",
                          "--tau-solve", "32", "--delta-init", "min"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("sssp_lower", "sssp_upper", "sssp_supersteps", "round_ratio",
                "level_clusters", "cluster2"):
        assert key in out, key
    assert out["sssp_lower"] <= out["phi_approx"]
    for bad in (["--levels", "-1"], ["--tau-solve", "1"]):
        with pytest.raises(SystemExit):
            launcher.main(["--device", "cpu"] + bad)

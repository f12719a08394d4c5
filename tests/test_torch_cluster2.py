"""CLUSTER2 (paper Algorithm 2) in the port against the JAX package:
the final planes of ``cluster2`` equal the reference's, with the port's
default draws, on the plain backend and on the kernel backend's plain
path, fused and unfused; the estimator and the launcher's ``--cluster2``.
Every plane is an integer, so every comparison is exact."""
import contextlib
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    @contextlib.contextmanager
    def _enable_x64(new_val: bool = True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = _enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import ClusterQuotientEstimator as RefCQ  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.core.backend import make_backend as ref_make_backend  # noqa: E402
from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.core.cluster import cluster2 as ref_cluster2  # noqa: E402
from repro.core.engine import run_cluster2 as ref_run_cluster2  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.core import (ClusterQuotientEstimator,  # noqa: E402
                              KernelBackend, cluster, cluster2, open_session,
                              run_cluster2)
from repro_torch.core.engine import default_cluster2_uniform_fn  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.launch import diameter as launcher  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain path's eager operations are small: one intra-op thread
    each, so that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CASES = {
    "road_like(2000) tau 4": (lambda g: g.road_like(2000, seed=0), 4),
    "road_like(6000) tau 16": (lambda g: g.road_like(6000, seed=1), 16),
    "social_like(10) tau 4": (lambda g: g.social_like(10, seed=0), 4),
    "grid_mesh(30) tau 6": (lambda g: g.grid_mesh(
        30, "bimodal", heavy_w=10**6, heavy_p=0.1, seed=0), 6),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, tau = CASES[request.param]
    ref_e = make(ref_gen)
    return ref_e, make(gen), tau, ref_cluster2(ref_e, tau)


def _assert_planes(got, want):
    np.testing.assert_array_equal(got.final_c, want.final_c)
    np.testing.assert_array_equal(got.final_pathw, want.final_pathw)
    for f in ("radius", "delta_end", "n_clusters", "n_stages",
              "growing_steps"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("backend,fuse", [("single", 0), ("kernel", 0),
                                          ("kernel", 8)])
def test_cluster2_matches_reference(case, backend, fuse):
    ref_e, e, tau, want = case
    be = (KernelBackend(e, device="cpu", fuse=fuse) if backend == "kernel"
          else backend)
    got = cluster2(e, tau, backend=be, device="cpu")
    _assert_planes(got, want)
    m, rm = got.metrics, want.metrics
    assert (m.stages, m.grow_calls) == (rm.stages, rm.grow_calls)
    # the kernel backend's plain path launches nothing on the CPU
    assert m.kernel_launches == 0


def test_cluster2_delta_is_twice_the_cluster_radius(case):
    ref_e, e, tau, want = case
    base = cluster(e, tau, backend="single", device="cpu")
    assert base.radius == ref_cluster(ref_e, tau).radius
    assert want.delta_end == max(2 * base.radius, 2)
    got = cluster2(e, tau, backend="single", device="cpu", base=base)
    _assert_planes(got, want)


def test_cluster2_draw_is_one_fold_in():
    """Stage i draws uniform(fold_in(PRNGKey(seed), i), n): one fold_in,
    not the stage engine's (stage, t) pair."""
    draw = default_cluster2_uniform_fn(5, "cpu")
    for i in (1, 2, 21):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(5), i), (777,)))
        np.testing.assert_array_equal(draw(i, 0, 777).numpy(), want)
        np.testing.assert_array_equal(draw(i, 3, 777).numpy(), want)


def test_barren_stages_run_no_grow():
    """A path of 300 nodes: stage i draws with p = 2^i / 300, so an early
    stage may draw no center (e^-2 at stage 1). Such a stage costs a read
    and no grow; the last stage takes every node left (p = 1)."""
    u = np.arange(299)
    w = np.full(299, 4)
    e = EdgeList.from_undirected(300, u, u + 1, w)
    ref_e = RefEdgeList.from_undirected(300, u, u + 1, w)
    barren = 0
    for seed in range(10):
        want = ref_run_cluster2(ref_e, ref_make_backend(ref_e, "single"), 4,
                                delta=6, seed=seed)
        with guard.metered() as meter:
            got = run_cluster2(e, KernelBackend(e, device="cpu"), 4,
                               delta=6, seed=seed)
        _assert_planes(got, want)
        m = got.metrics
        assert m.grow_calls == want.metrics.grow_calls == got.n_stages
        assert m.stages == want.metrics.stages >= got.n_stages
        assert meter.transfers == m.host_syncs + m.finalize_syncs
        barren += m.stages - got.n_stages
    assert barren > 0


def test_cluster2_degenerate_graphs():
    z = np.zeros(0, np.int64)
    dec = cluster2(EdgeList(0, z, z, z), 4, backend="single", device="cpu")
    assert dec.n_nodes == 0 and dec.n_clusters == 0
    # edgeless: every node ends its own center
    dec = cluster2(EdgeList(5, z, z, z), 2, backend="single", device="cpu")
    assert dec.n_clusters == 5 and dec.radius == 0


FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
          "growing_steps", "n_stages", "delta_end", "connected")


@pytest.mark.parametrize("via", ["estimator", "config"])
def test_cluster2_estimator_matches_reference(case, via):
    ref_e, e, tau, _ = case
    want = ref_open_session(ref_e, tau=tau).estimate(
        RefCQ(use_cluster2=True))
    if via == "estimator":
        session = open_session(e, tau=tau, device="cpu")
        est = ClusterQuotientEstimator(use_cluster2=True)
    else:
        session = open_session(e, GraphEngineConfig(use_cluster2=True),
                               tau=tau, device="cpu")
        est = ClusterQuotientEstimator()
    with guard.metered() as meter:
        got = session.estimate(est)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.quotient_ecc, want.quotient_ecc)
    # the base CLUSTER run's reads are counted with CLUSTER2's
    assert meter.transfers == got.pipeline.total_host_syncs
    base = cluster(e, tau, backend="single", device="cpu").metrics
    assert got.pipeline.decompose_syncs > base.host_syncs + base.finalize_syncs


def test_launcher_cluster2(capsys):
    assert launcher.main(["--graph", "road", "--n", "3000", "--device", "cpu",
                          "--cluster2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = ref_open_session(ref_gen.road_like(3000, seed=0)).estimate(
        RefCQ(use_cluster2=True))
    assert out["cluster2"] is True
    assert (out["phi_approx"], out["clusters"], out["supersteps"]) == (
        want.phi_approx, want.n_clusters, want.growing_steps)


def test_cluster2_on_a_gpu_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    e = gen.road_like(100, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        cluster2(e, 4)

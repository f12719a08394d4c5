"""Resident graph serving in the port against the JAX package: the pool's
padding (``_pad_edges``, inert ``0 -> 0, w = 1`` self-loops, the empty
graph unpadded), pooled estimates equal to unpooled ones and to the
reference's pooled ones on the plain and kernel backends (fused and not,
with a group whose padding makes row 0 a long row), the SSSP estimators
over the padded CSR, a per-query ``delta_init`` resolved from the real
edges, the warm-query counters, close idempotence, the deprecated
wrappers (``solver="scipy"`` too), and ``serve --mode graph-diameter``
(every estimator, its contracts and refusals). Store-backed sessions:
``spill()`` and the auto-unspill (one more build and upload, the same
estimate), the pool's ``shards`` and ``g<i>`` checkpoint directories
against the reference's pool, the launchers' ``--shards``, ``--compress``,
``--checkpoint-dir``, ``--resume`` and ``--preempt-after`` (a serve
subprocess killed by a real SIGTERM exits 75, and its ``--resume`` rerun
gives the uninterrupted estimate). Every compared value is an integer, so
every comparison is exact."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import GraphEngineConfig as RefCfg  # noqa: E402
from repro.core import SessionPool as RefPool  # noqa: E402
from repro.core import diameter as ref_diameter  # noqa: E402
from repro.core import session as ref_session  # noqa: E402
from repro.core import ClusterQuotientEstimator as RefCQ  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.core import (EDGE_BUCKET, CascadeEstimator,  # noqa: E402
                              ClusterQuotientEstimator,
                              DeltaSteppingEstimator, IntervalEstimator,
                              LowerBoundEstimator, SessionPool,
                              approximate_diameter,
                              approximate_diameter_batch, open_session)
from repro_torch.core import diameter as port_diameter  # noqa: E402
from repro_torch.core.session import _pad_edges  # noqa: E402
from repro_torch.graph import EdgeStore, GraphStore  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.kernels.edge_relax.kernel import LONG_ROW  # noqa: E402
from repro_torch.launch import diameter as diameter_launcher  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.fault import EXIT_PREEMPTED  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

CPU = torch.device("cpu")
FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
          "growing_steps", "n_stages", "delta_end", "connected", "lower",
          "upper")


def _edgeless(n):
    z = np.zeros(0, np.int32)
    return EdgeList(n, z, z, z)


def _ref(e: EdgeList) -> RefEdgeList:
    return RefEdgeList(e.n_nodes, e.src.copy(), e.dst.copy(),
                       e.weight.copy())


def _drop_edges(e: EdgeList, k: int, seed: int) -> EdgeList:
    """``e`` with ``k`` directed edges removed (same node count)."""
    keep = np.sort(np.random.default_rng(seed).permutation(e.n_edges)
                   [:e.n_edges - k])
    return EdgeList(e.n_nodes, e.src[keep], e.dst[keep], e.weight[keep])


def _same_as_ref(a, b):
    """The estimate fields the reference also computes, equal."""
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    if a.quotient_ecc is not None or b.quotient_ecc is not None:
        np.testing.assert_array_equal(a.quotient_ecc, b.quotient_ecc)


def _same_estimate(a, b):
    """Every field of two port estimates equal, the pipeline counters
    included; only the host-clock seconds may differ."""
    _same_as_ref(a, b)
    pa, pb = dataclasses.asdict(a.pipeline), dataclasses.asdict(b.pipeline)
    for k in pa:
        if not k.endswith("seconds"):
            assert pa[k] == pb[k], k
    if a.decomposition is not None:
        np.testing.assert_array_equal(a.decomposition.final_c,
                                      b.decomposition.final_c)
        np.testing.assert_array_equal(a.decomposition.final_pathw,
                                      b.decomposition.final_pathw)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

PAD_CASES = {
    "road pad to bucket": (lambda g: g.road_like(300, seed=0), None),
    "road pad 3000": (lambda g: g.road_like(300, seed=0), 3000),
    "no pad (e_pad < e)": (lambda g: g.road_like(300, seed=0), 10),
    "mesh": (lambda g: g.grid_mesh(9, "uniform", high=50, seed=1), 512),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_edges_matches_reference(case):
    make, e_pad = PAD_CASES[case]
    e, r = make(gen), make(ref_gen)
    if e_pad is None:
        e_pad = -(-e.n_edges // EDGE_BUCKET) * EDGE_BUCKET
    p, rp = _pad_edges(e, e_pad), ref_session._pad_edges(r, e_pad)
    assert p.n_nodes == rp.n_nodes and p.n_edges == max(e.n_edges, e_pad)
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(p, f), getattr(rp, f))
        assert getattr(p, f).dtype == np.int32
    tail = slice(e.n_edges, None)
    assert (p.src[tail] == 0).all() and (p.dst[tail] == 0).all()
    assert (p.weight[tail] == 1).all()


@pytest.mark.parametrize("n", [0, 3])
def test_pad_edges_empty_graph(n):
    """A graph without nodes stays unpadded (no phantom node 0); one with
    nodes and no edges gets the self-loops, as in the reference."""
    p = _pad_edges(_edgeless(n), 256)
    rp = ref_session._pad_edges(_ref(_edgeless(n)), 256)
    assert p.n_edges == rp.n_edges == (0 if n == 0 else 256)
    np.testing.assert_array_equal(p.src, rp.src)


# ---------------------------------------------------------------------------
# pooled = unpooled = the reference's pooled
# ---------------------------------------------------------------------------

def _group(g):
    """Three graphs of one node count: two road graphs and one with 1,200
    edges fewer, so its padding (>= 1,200 self-loops) makes row 0 a long
    row of the kernel backend's CSR."""
    a, b = g.road_like(600, seed=0), g.road_like(600, seed=1)
    return [a, b, _drop_edges(a, 1200, seed=3)]


@pytest.fixture(scope="module")
def ref_pooled():
    graphs = [_ref(e) for e in _group(gen)]
    with RefPool(RefCfg()) as pool:
        return pool.estimate_many(graphs, tau=6)


@pytest.mark.parametrize("backend,fuse", [("single", 0), ("kernel", 0),
                                          ("kernel", 8)])
def test_pooled_equals_unpooled_and_reference(ref_pooled, backend, fuse):
    graphs = _group(gen)
    cfg = GraphEngineConfig(backend=backend, fuse_supersteps=fuse)
    with SessionPool(cfg, device=CPU) as pool:
        pooled = pool.estimate_many(graphs, tau=6)
        resident = [pool.open(g, tau=6, e_pad=graphs[0].n_edges + 256)
                    for g in graphs]
        if backend == "kernel":
            # the padded graph's row 0 is a long row of the CSR
            assert 0 in resident[2].backend.graph.long_rows.tolist()
            assert resident[2].n_edges - graphs[2].n_edges > LONG_ROW
        for g, p, s, r in zip(graphs, pooled, resident, ref_pooled):
            solo = open_session(g, cfg, tau=6, device=CPU).estimate()
            _same_estimate(p, solo)
            _same_estimate(s.estimate(), solo)
            _same_as_ref(p, r)


@pytest.mark.parametrize("backend", ["single", "kernel"])
def test_sssp_estimators_on_padded_sessions(backend):
    """The SSSP estimators read the padded CSR through ``flat_edges()``:
    the self-loops change no distance, so every bound equals the unpadded
    session's."""
    g = _drop_edges(gen.road_like(500, seed=2), 1500, seed=4)
    with SessionPool(GraphEngineConfig(backend=backend), device=CPU) as pool:
        padded = pool.open(g, e_pad=g.n_edges + 2048)
        solo = open_session(g, backend=backend, device=CPU)
        for est in (DeltaSteppingEstimator(seed=1),
                    DeltaSteppingEstimator(seed=1, delta=64),
                    LowerBoundEstimator(rounds=3, seed=2)):
            a, b = padded.estimate(est), solo.estimate(est)
            _same_as_ref(a, b)
            assert a.growing_steps == b.growing_steps


@pytest.mark.parametrize("mode", ["avg", "min"])
def test_pooled_delta_init_override_matches_unpooled(mode):
    """A per-query symbolic delta_init on a POOLED session resolves over
    the real edges, not the w = 1 padding, as the reference's does."""
    g = gen.grid_mesh(8, "uniform", high=2000, seed=4)   # few heavy edges
    est = ClusterQuotientEstimator(delta_init=mode)
    with SessionPool(device=CPU) as pool:
        pooled = pool.open(g, tau=4)
        assert pooled.n_edges > g.n_edges   # padding happened
        assert pooled.resolve_delta_init(mode) != \
            pooled.resolve_delta_init(str(1))
        a = pooled.estimate(est)
    b = open_session(g, tau=4, device=CPU).estimate(est)
    _same_estimate(a, b)
    ref = RefPool().open(_ref(g), tau=4).estimate(RefCQ(delta_init=mode))
    _same_as_ref(a, ref)


def test_pool_empty_graph_gets_no_phantom_node():
    with SessionPool(device=CPU) as pool:
        sess = pool.open(_edgeless(0))
        assert sess.n_nodes == 0 and sess.n_edges == 0
        est = sess.estimate()
        assert est.phi_approx == 0 and est.connected
        graphs = [_edgeless(0), gen.grid_mesh(6, "unit"), _edgeless(3)]
        ests = pool.estimate_many(graphs, tau=4)
    refs = RefPool().estimate_many([_ref(g) for g in graphs], tau=4)
    for a, r in zip(ests, refs):
        _same_as_ref(a, r)
    assert not ests[2].connected


def test_warm_queries_make_no_builds_and_no_uploads():
    graphs = [gen.road_like(300, seed=s) for s in range(2)]
    with SessionPool(device=CPU) as pool:
        sessions = [pool.open(g, tau=4) for g in graphs]
        assert len({s.n_edges for s in sessions}) == 1   # one bucket
        m = pool.metrics
        assert (m.sessions_opened, m.backend_builds, m.edge_uploads) == \
            (2, 2, 2)
        for _ in range(2):
            for s in sessions:
                s.estimate(CascadeEstimator(levels=1, tau_solve=8))
                s.estimate(DeltaSteppingEstimator())
        assert (m.backend_builds, m.edge_uploads) == (2, 2)
        assert m.queries == m.warm_queries == 8


def test_pool_close_idempotent_and_pooled_sessions_reject_use():
    g = gen.grid_mesh(4, "unit")
    pool = SessionPool(device=CPU)
    sess = pool.open(g, tau=2)
    sess.estimate()
    pool.close()
    pool.close()   # idempotent
    assert pool.sessions == []
    for use in (lambda: sess.estimate(), lambda: sess.flat_device_edges(),
                lambda: sess.max_weight, lambda: pool.open(g),
                lambda: pool.estimate_many([g])):
        with pytest.raises(RuntimeError, match="closed"):
            use()
    with SessionPool(device=CPU) as pool2:
        s2 = pool2.open(g, tau=2)
    with pytest.raises(RuntimeError, match="closed"):
        s2.estimate()


def test_pool_argument_validation():
    with pytest.raises(ValueError, match="tau_solve"):
        SessionPool(tau_solve=1, device=CPU)
    with pytest.raises(ValueError, match="tau"):
        SessionPool(device=CPU).estimate_many([gen.grid_mesh(4, "unit")],
                                              tau=0)
    if not torch.cuda.is_available():   # entry points default to CUDA
        with pytest.raises(RuntimeError, match="cuda"):
            SessionPool()


# ---------------------------------------------------------------------------
# the deprecated wrappers
# ---------------------------------------------------------------------------

def test_wrapper_warns_and_matches_session_path_and_reference():
    g = gen.road_like(800, seed=5)
    with pytest.deprecated_call():
        old = approximate_diameter(g, tau=8, device=CPU)
    new = open_session(g, tau=8, device=CPU).estimate(
        ClusterQuotientEstimator())
    _same_estimate(old, new)
    with pytest.deprecated_call():
        ref = ref_diameter.approximate_diameter(_ref(g), tau=8)
    _same_as_ref(old, ref)


def test_batch_wrapper_matches_pool_path_and_reference():
    graphs = [gen.road_like(500, seed=s) for s in range(2)]
    graphs.append(gen.grid_mesh(10, "uniform", high=50, seed=1))  # 2nd group
    with pytest.deprecated_call():
        old = approximate_diameter_batch(graphs, tau=6, device=CPU)
    new = SessionPool(device=CPU).estimate_many(graphs, tau=6)
    with pytest.deprecated_call():
        ref = ref_diameter.approximate_diameter_batch(
            [_ref(g) for g in graphs], tau=6)
    for a, b, r in zip(old, new, ref):
        _same_estimate(a, b)
        _same_as_ref(a, r)


@pytest.mark.parametrize("make", [
    lambda g: g.grid_mesh(12, "uniform", high=100, seed=2),
    lambda g: g.road_like(400, seed=3),
    lambda g: g.social_like(9, seed=1)])
def test_wrapper_scipy_solver_equals_device(make):
    g = make(gen)
    with pytest.deprecated_call():
        dev = approximate_diameter(g, tau=6, device=CPU)
    with pytest.deprecated_call():
        ora = approximate_diameter(g, tau=6, solver="scipy", device=CPU)
    with pytest.deprecated_call():
        ref = ref_diameter.approximate_diameter(_ref(g), tau=6,
                                                solver="scipy")
    assert (dev.phi_approx, dev.connected) == (ora.phi_approx, ora.connected)
    assert (ora.phi_approx, ora.connected, ora.n_clusters) == (
        ref.phi_approx, ref.connected, ref.n_clusters)
    assert ora.quotient_ecc is None
    with pytest.raises(ValueError, match="solver"):
        ClusterQuotientEstimator(solver="host").estimate(
            open_session(g, device=CPU))


def test_wrapper_module_reexports():
    for name in ("EDGE_BUCKET", "SessionPool", "_pad_edges", "tau_for",
                 "PipelineMetrics", "DiameterEstimate"):
        assert hasattr(port_diameter, name) and hasattr(ref_diameter, name)
    assert port_diameter.EDGE_BUCKET == ref_diameter.EDGE_BUCKET == 256


# ---------------------------------------------------------------------------
# serve --mode graph-diameter
# ---------------------------------------------------------------------------

SERVE = ["--mode", "graph-diameter", "--device", "cpu", "--batch", "2",
         "--graph-n", "300", "--queries", "2", "--tau", "4"]


def _serve(capsys, *extra):
    rc = serve.main(SERVE + list(extra))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, out


@pytest.mark.parametrize("estimator", ["cluster", "sssp", "lower",
                                       "interval", "cascade"])
def test_serve_graph_diameter_estimators(capsys, estimator):
    rc, out = _serve(capsys, "--estimator", estimator, "--backend", "single")
    assert rc == 0 and out["failures"] == []
    assert out["estimator"] == estimator
    assert out["warm_backend_builds"] == out["warm_edge_uploads"] == 0
    assert len(out["per_query"]) == 4 and len(out["warm_seconds"]) == 2
    # every host read is a counted one
    assert out["transfers"] == out["counted_host_syncs"] == sum(
        q["total_host_syncs"] for q in out["per_query"])
    # every round of a session gives the same answer
    for i in range(2):
        rounds = [q for q in out["per_query"] if q["graph"] == i]
        assert rounds[0]["upper"] == rounds[1]["upper"]
        assert rounds[0]["lower"] == rounds[1]["lower"]


def test_serve_graph_diameter_matches_session_path():
    """The served estimates are the pool's: each equals an unpooled query
    of the same graph."""
    args = serve.parse_args(SERVE + ["--levels", "1", "--tau-solve", "8"])
    res = serve.serve_graph_diameter(args)
    assert res["estimator"] == "cascade" and not res["failures"]
    from repro_torch.launch.diameter import build_graph

    for i, _, est in res["results"]:
        g = build_graph("road", 300, seed=i)
        solo = open_session(g, tau=4, tau_solve=8, device=CPU).estimate(
            CascadeEstimator(levels=1))
        _same_estimate(est, solo)


def test_serve_graph_diameter_autotune(capsys):
    rc, out = _serve(capsys, "--autotune", "auto", "--engine-mode", "auto")
    assert rc == 0 and not out["failures"]
    assert all(t is not None for t in out["tuning"])
    assert out["engine_mode"] == [t["mode"] for t in out["tuning"]]
    assert out["tau"] == [4, 4]   # --tau stays pinned


def test_serve_graph_diameter_contracts_fail(capsys):
    rc, out = _serve(capsys, "--sync-budget", "0")
    assert rc == 1 and any("budget" in f for f in out["failures"])
    rc, out = _serve(capsys, "--check-amortization", "1e9")
    assert rc == 1 and any("amortization" in f for f in out["failures"])


@pytest.mark.parametrize("flags,message", [
    (["--update-trace", "-1"], "--update-trace must be >= 0"),
    (["--sync-budget", "bench"], "JAX package's host reads"),
    (["--sync-budget", "many"], "off | <int>"),
    (["--engine-mode", "fast"], None),
    (["--queries", "0"], "--queries"),
    (["--resume"], "--resume requires --checkpoint-dir"),
    (["--preempt-after", "2"], "--preempt-after requires --checkpoint-dir"),
    (["--shards", "-1"], "--shards must be >= 0"),
])
def test_serve_graph_diameter_refusals(capsys, flags, message):
    if message is None:
        with pytest.raises(ValueError, match="unknown engine mode"):
            serve.main(SERVE + flags)
        return
    with pytest.raises(SystemExit) as exc:
        serve.main(SERVE + flags)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_serve_metered_transfers_equal_query_syncs():
    """``guard.metered()`` around a query loop counts exactly the queries'
    ``total_host_syncs`` on both backends."""
    g = gen.road_like(400, seed=1)
    for backend in ("single", "kernel"):
        with SessionPool(GraphEngineConfig(backend=backend),
                         device=CPU) as pool:
            sess = pool.open(g, tau=4)
            with guard.metered() as meter:
                res = [sess.estimate(e) for e in (
                    ClusterQuotientEstimator(), IntervalEstimator(),
                    CascadeEstimator(levels=1, tau_solve=8))]
            assert meter.transfers == sum(r.pipeline.total_host_syncs
                                          for r in res)


# ---------------------------------------------------------------------------
# store-backed sessions, spill, sharded pools and checkpoint flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,fuse,store_kind", [
    ("single", 0, "graph"), ("kernel", 0, "graph"), ("kernel", 8, "edge")])
def test_spill_and_auto_unspill(backend, fuse, store_kind):
    """A store-backed session equals the flat one; ``spill()`` drops the
    backend and the store's device arrays; the next query unspills (one
    more build, one more upload, the query not warm) and gives the same
    estimate."""
    g = gen.road_like(600, seed=4)
    cfg = GraphEngineConfig(fuse_supersteps=fuse)
    flat = open_session(g, cfg, tau=4, backend=backend, device=CPU).estimate(
        CascadeEstimator(levels=1, tau_solve=8))
    st = (GraphStore(g, n_shards=2, device=CPU) if store_kind == "graph"
          else EdgeStore(g, device=CPU))
    with open_session(None, cfg, store=st, tau=4, backend=backend) as sess:
        est = CascadeEstimator(levels=1, tau_solve=8)
        first = sess.estimate(est)
        _same_as_ref(first, flat)
        m = sess.metrics
        builds, uploads, store_uploads = (m.backend_builds, m.edge_uploads,
                                          st.uploads)
        sess.spill()
        sess.spill()   # idempotent
        assert sess.spilled and sess.backend is None and st.src is None
        again = sess.estimate(est)
        assert not sess.spilled and st.src is not None
        assert (m.backend_builds, m.edge_uploads, st.uploads) == (
            builds + 1, uploads + 1, store_uploads + 1)
        _same_estimate(again, first)
        if backend == "kernel":
            # the CSR came from the store through rebind: inert tail
            assert sess.backend.graph.inert_tail
    assert st.src is None   # close() released the device arrays


def test_spill_refusals():
    g = gen.road_like(200, seed=1)
    with open_session(g, tau=4, device=CPU) as sess:
        with pytest.raises(RuntimeError, match="store-backed"):
            sess.spill()
    with open_session(None, store=EdgeStore(g, device=CPU), tau=4) as sess:
        sess.apply_updates(_one_insert(g))
        with pytest.raises(RuntimeError, match="dynamic mode"):
            sess.spill()
    with pytest.raises(ValueError, match="edges or a store"):
        open_session(None, device=CPU)
    closed = open_session(None, store=EdgeStore(g, device=CPU), tau=4)
    closed.close()
    with pytest.raises(RuntimeError, match="closed"):
        closed.spill()


def _one_insert(g):
    from repro_torch.core import UpdateBatch

    return UpdateBatch.inserts([0], [g.n_nodes - 1], [5])


def test_pool_shards_and_checkpoint_dirs_match_reference(tmp_path):
    """``shards=2``: every session is backed by a 2-shard GraphStore and
    checkpoints under ``g<i>``; the estimates equal the reference's pool
    with the same knobs and the port's flat pool."""
    graphs = [gen.road_like(300, seed=s) for s in (1, 2)]
    d, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    ref_pool = RefPool(RefCfg(), checkpoint_dir=d_ref, shards=2)
    pool = SessionPool(GraphEngineConfig(), device=CPU, checkpoint_dir=d,
                       shards=2)
    flat = SessionPool(GraphEngineConfig(), device=CPU)
    try:
        for i, g in enumerate(graphs):
            sess = pool.open(g, tau=4)
            assert isinstance(sess.store, GraphStore)
            assert sess.store.n_shards == 2
            assert sess.checkpoint_dir == os.path.join(d, f"g{i}")
            assert sess.checkpointer.store is sess.store
            with guard.metered() as meter:
                est = sess.estimate()
            pm = est.pipeline
            assert pm.checkpoint_syncs > 0
            assert meter.transfers == pm.total_host_syncs + \
                pm.checkpoint_syncs
            want = ref_pool.open(_ref(g), tau=4).estimate()
            _same_as_ref(est, want)
            _same_as_ref(est, flat.open(g, tau=4).estimate())
            assert os.listdir(sess.checkpoint_dir) == []   # completed
        with pytest.raises(ValueError, match="shards"):
            SessionPool(device=CPU, shards=-1)
    finally:
        for p in (ref_pool, pool, flat):
            p.close()


def test_serve_shards_and_checkpoints_keep_reads_counted(capsys, tmp_path):
    rc, flat = _serve(capsys, "--levels", "1", "--tau-solve", "8")
    rc2, out = _serve(capsys, "--levels", "1", "--tau-solve", "8",
                      "--shards", "2", "--checkpoint-dir", str(tmp_path))
    assert rc == rc2 == 0 and not out["failures"]
    assert out["shards"] == 2
    assert out["transfers"] == out["counted_host_syncs"] > sum(
        q["total_host_syncs"] for q in out["per_query"])
    assert all(c["saves"] > 0 and c["restores"] == 0
               for c in out["checkpoint"])
    assert [q["phi_approx"] for q in out["per_query"]] == \
        [q["phi_approx"] for q in flat["per_query"]]
    assert sorted(os.listdir(tmp_path)) == ["g0", "g1"]


def test_serve_preempt_then_resume_in_a_subprocess(tmp_path):
    """A real SIGTERM at stage boundary 2 of the first session: the run
    exits 75 with its step saved; ``--resume`` exits 0 with the estimate
    of an uninterrupted run."""
    argv = ["--mode", "graph-diameter", "--device", "cpu", "--batch", "1",
            "--graph-n", "4096", "--queries", "1", "--tau", "4",
            "--levels", "2", "--tau-solve", "64"]
    # one intra-op thread, as this file's fixture sets for itself
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    ck = ["--checkpoint-dir", str(tmp_path)]

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv,
             *extra], capture_output=True, text=True, env=env, cwd=REPO,
            timeout=300)

    killed = run(*ck, "--preempt-after", "2")
    assert killed.returncode == EXIT_PREEMPTED, killed.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "g0")) == ["step_00000001",
                                                "step_00000002"]
    resumed = run(*ck, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    out = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert out["checkpoint"][0]["restores"] == 1
    assert os.listdir(tmp_path / "g0") == []
    whole = serve.serve_graph_diameter(serve.parse_args(argv))
    assert [q["phi_approx"] for q in out["per_query"]] == \
        [r.phi_approx for _, _, r in whole["results"]]
    assert out["per_query"][0]["clusters"] == \
        whole["results"][0][2].n_clusters


def test_diameter_launcher_store_and_checkpoint_flags(capsys, tmp_path):
    base = ["--n", "1500", "--tau", "4", "--device", "cpu", "--levels", "1",
            "--tau-solve", "16"]

    def launch(*extra):
        assert diameter_launcher.main(base + list(extra)) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    flat = launch()
    sharded = launch("--shards", "4", "--compress", "--partition", "cluster")
    ckpt = launch("--checkpoint-dir", str(tmp_path))
    keys = ("phi_approx", "radius", "clusters", "quotient_edges", "stages",
            "supersteps", "solve_supersteps", "host_syncs", "level_clusters",
            "level_supersteps")
    for out in (sharded, ckpt):
        assert {k: out[k] for k in keys} == {k: flat[k] for k in keys}
    st = sharded["store"]
    assert st["shards"] == 4 and st["compress"]
    assert st["host_slab_bytes"] < st["raw_bytes"] <= \
        st["device_edge_bytes"]
    assert st["halo_bytes_per_superstep"] < \
        st["fullplane_bytes_per_superstep"]
    assert "store" not in flat and "checkpoint" not in flat
    assert ckpt["checkpoint"]["saves"] == ckpt["stages"] > 0
    assert ckpt["checkpoint_syncs"] == 9 * ckpt["checkpoint"]["saves"]
    for flags, msg in ((["--resume"], "--resume requires --checkpoint-dir"),
                       (["--shards", "-2"], "--shards must be >= 0")):
        with pytest.raises(SystemExit) as exc:
            diameter_launcher.main(base + flags)
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err

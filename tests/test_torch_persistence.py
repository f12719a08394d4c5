"""Durable decompositions in the port against the JAX package.

  * ``runtime/fault``: the preemption guard (a real SIGTERM, handlers put
    back on exit), ``Preempted`` escaping ``retriable``, the retry schedule
    and the straggler monitor (the reference's ``test_runtime`` cases).
  * ``checkpoint``: a round trip of a tree of dicts, tuples, NamedTuples
    and dataclasses of tensors and arrays, garbage collection,
    ``latest_step``, a partial write never taken as the latest step, and a
    directory the reference's ``checkpoint.save`` wrote, restored equal.
  * ``StageCheckpointer``: the same graph, seed and tau through the
    reference's and the port's (single, kernel, fused kernel); every
    ``step_<k>`` holds the same leaves with byte-identical arrays and an
    equal manifest ``extra``. A kill by a real SIGTERM at boundaries 1, 2
    and the last, then a resume, finishes byte-identical to the
    uninterrupted run and to the reference; the port also finishes a run
    the reference's kill left behind.
  * the ``paper-graph`` arch (full and smoke) field for field, its cell's
    superstep against the reference's ``growth_loop`` + ``edge_relax_ref``
    on the same planes, and both example scripts against the reference's.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import contextlib
import dataclasses
import io
import json
import os
import runpy
import signal
import sys
from typing import NamedTuple

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import checkpoint as ref_ckpt  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.core import ClusterQuotientEstimator as RefCQ  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.core import state as ref_state  # noqa: E402
from repro.core.delta_growing import growth_loop as ref_growth  # noqa: E402
from repro.core.engine import StageCheckpointer as RefCkpt  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.storage import GraphStore as RefGraphStore  # noqa: E402
from repro.kernels.edge_relax.ref import edge_relax_ref  # noqa: E402
from repro.runtime.fault import PreemptionGuard as RefGuard  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ClusterQuotientEstimator,
    StageCheckpointer,
    open_session,
)
from repro_torch.core.backend import (  # noqa: E402
    KernelBackend,
    SingleDeviceBackend,
)
from repro_torch.graph import GraphStore  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.runtime.fault import (  # noqa: E402
    Preempted,
    PreemptionGuard,
    StragglerMonitor,
    retriable,
)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ESTIMATE_FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
                   "growing_steps", "n_stages", "delta_end", "connected")
BACKENDS = [("single", 0), ("kernel", 0), ("kernel", 8)]


# ---------------------------------------------------------------------------
# fault
# ---------------------------------------------------------------------------


def test_preemption_guard_catches_sigterm():
    with PreemptionGuard() as g:
        assert not g.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.should_stop
        assert g.received == signal.SIGTERM


def test_preemption_guard_restores_handlers_on_exit():
    seen = []
    prev_term = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard() as g:
            assert signal.getsignal(signal.SIGTERM) == g._handler
        assert signal.getsignal(signal.SIGTERM) is not g._handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]   # the outer handler is back
        assert not g.should_stop          # the exited guard saw nothing
    finally:
        signal.signal(signal.SIGTERM, prev_term)


def test_preempted_is_not_retried():
    calls = {"n": 0}

    def preempts():
        calls["n"] += 1
        raise Preempted(3, "ckpt/step_3")

    with pytest.raises(Preempted) as e:
        retriable(preempts, base_delay=0.001)()
    assert calls["n"] == 1
    assert e.value.stage == 3 and e.value.path == "ckpt/step_3"
    assert not isinstance(e.value, RuntimeError)


def test_retriable_retries_then_succeeds_or_exhausts(monkeypatch):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert retriable(flaky, base_delay=0.001)() == "ok"
    assert calls["n"] == 3
    slept = []
    monkeypatch.setattr("repro_torch.runtime.fault.time.sleep", slept.append)
    calls["n"] = 0

    def always_fails():
        calls["n"] += 1
        raise OSError(f"boom {calls['n']}")

    with pytest.raises(OSError, match="boom 4"):
        retriable(always_fails, retries=3, base_delay=0.1)()
    assert calls["n"] == 4
    assert slept == [0.1, 0.2, 0.4]


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=2.0)
    for i in range(8):
        assert not m.record(i, 0.1)
    assert m.record(8, 0.5)
    assert m.flagged == [8]
    assert not m.record(9, 0.11)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


class Pair(NamedTuple):
    a: torch.Tensor
    b: np.ndarray


@dataclasses.dataclass(frozen=True)
class Planes:
    x: torch.Tensor
    y: torch.Tensor


def _tree(seed: int):
    r = np.random.default_rng(seed)
    return {"planes": Planes(torch.from_numpy(r.integers(0, 9, 5,
                                                         dtype=np.int32)),
                             torch.from_numpy(r.random(4) < 0.5)),
            "key": np.asarray([0, seed], np.uint32),
            "nested": (Pair(torch.arange(3, dtype=torch.int64),
                            r.random(2).astype(np.float32)), None,
                       {"z": np.int32(seed)})}


def _leaves_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        # a tensor comes back a tensor, anything else a numpy array
        assert isinstance(x, torch.Tensor) == isinstance(y, torch.Tensor), k
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


def test_checkpoint_round_trip_gc_and_latest(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    assert ckpt.latest_step(os.path.join(d, "absent")) is None
    with guard.metered() as meter:
        for step in (1, 2, 5, 7):
            path = ckpt.save(d, step, _tree(step), extra={"s": step})
    # three tensor leaves a save, each through guard.fetch
    assert meter.transfers == 4 * 3
    assert path == os.path.join(d, "step_00000007")
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000005",
                                     "step_00000007"]   # keep=3
    assert ckpt.latest_step(d) == 7
    like = _tree(0)
    tree, extra = ckpt.restore(d, like)
    _leaves_equal(tree, _tree(7))
    assert extra == {"s": 7}
    tree, extra = ckpt.restore(d, like, step=5)
    _leaves_equal(tree, _tree(5))
    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        man = json.load(f)
    assert sorted(man) == ["extra", "leaves", "step", "written_at"]
    assert list(man["leaves"]) == ["key", "nested__0__a", "nested__0__b",
                                   "nested__2__z", "planes__x", "planes__y"]
    assert man["leaves"]["planes__y"] == {"file": "planes__y.npy",
                                          "shape": [4], "dtype": "bool"}
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.restore(d, {**like, "more": np.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(os.path.join(d, "absent"), like)
    ckpt.save(d, 8, _tree(8), keep=0)
    ckpt.save(d, 9, _tree(9), keep=0)
    assert len(os.listdir(d)) == 5


def test_partial_write_is_never_the_latest_step(tmp_path, monkeypatch):
    """A writer killed midway leaves only its tmp directory: the previous
    step stays the latest and restores intact."""
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(1))
    calls = {"n": 0}
    real = ckpt._write_npy

    def dies_on_the_second_leaf(path, arr):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("killed")
        real(path, arr)

    monkeypatch.setattr(ckpt, "_write_npy", dies_on_the_second_leaf)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(d, 2, _tree(2))
    assert any(x.startswith("tmp.2.") for x in os.listdir(d))
    assert ckpt.latest_step(d) == 1
    tree, _ = ckpt.restore(d, _tree(0))
    _leaves_equal(tree, _tree(1))


def test_restores_a_directory_the_reference_wrote(tmp_path):
    d = str(tmp_path)
    r = np.random.default_rng(2)
    planes = ref_state.EngineState(*[jnp.asarray(r.integers(
        -5, 5, 6, dtype=np.int32)) for _ in range(6)],
        jnp.asarray(r.random(6) < 0.5), jnp.asarray(r.random(6) < 0.5))
    store = {"h_src": r.integers(0, 9, 8, dtype=np.int32),
             "free": np.arange(3, dtype=np.int64)}
    ref_ckpt.save(d, 3, {"planes": planes, "key": jax.random.PRNGKey(11),
                         "store": store}, extra={"engine": {"stage": 3}})
    like_planes = dataclasses.replace(
        open_session(EdgeList(6, [0], [1], [1]), device="cpu",
                     backend="single").backend.init_state())
    like = {"planes": like_planes, "key": np.zeros(2, np.uint32),
            "store": {"h_src": np.zeros(0, np.int32),
                      "free": np.zeros(0, np.int64)}}
    tree, extra = ckpt.restore(d, like)
    assert extra == {"engine": {"stage": 3}}
    for f in dataclasses.fields(like_planes):
        got = getattr(tree["planes"], f.name)
        assert got.dtype == getattr(like_planes, f.name).dtype
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(planes, f.name)))
    np.testing.assert_array_equal(tree["key"], [0, 11])
    assert tree["key"].dtype == np.uint32
    np.testing.assert_array_equal(tree["store"]["h_src"], store["h_src"])


def test_bfloat16_leaves_are_the_reference_files(tmp_path):
    """bfloat16 leaves (0-d, 1-d and 2-d; random bits with NaN, inf, -0 and
    a subnormal among them) beside float32 and int32 leaves and a 0-d
    int32 step: the port's files equal the reference's byte for byte and
    so do the manifests' leaves; the port's restore of either directory
    gives back the same bfloat16 bits and every leaf's shape (a float32
    ``like`` takes the bf16 values exactly); the reference's restore of
    the port's directory hands back its void words."""
    r = np.random.default_rng(5)
    words = {"w": r.integers(0, 1 << 16, (3, 5), dtype=np.uint16),
             "b": np.array([0x7FC0, 0x7F80, 0x8000, 0x0001, 0x3F80],
                           np.uint16),
             "s": np.array(0xC040, np.uint16)}
    other = {"f": r.standard_normal(4).astype(np.float32),
             "step": np.array(7, np.int32)}
    ref_tree = {"params": {k: jnp.asarray(v.view(jnp.bfloat16))
                           for k, v in words.items()},
                **{k: jnp.asarray(v) for k, v in other.items()}}
    tree = {"params": {k: torch.from_numpy(v.view(np.int16)).view(
                torch.bfloat16) for k, v in words.items()},
            **{k: torch.from_numpy(v) for k, v in other.items()}}
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "port")
    p_ref = ref_ckpt.save(d_ref, 4, ref_tree, extra={"s": 1})
    p = ckpt.save(d, 4, tree, extra={"s": 1})
    with open(os.path.join(p_ref, "manifest.json")) as f:
        man_ref = json.load(f)
    with open(os.path.join(p, "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"] == man_ref["leaves"]
    assert man["leaves"]["params__w"]["dtype"] == "bfloat16"
    for leaf in man["leaves"].values():
        with open(os.path.join(p_ref, leaf["file"]), "rb") as f:
            want = f.read()
        with open(os.path.join(p, leaf["file"]), "rb") as f:
            assert f.read() == want, leaf["file"]
    like = {"params": {k: torch.zeros(v.shape, dtype=torch.bfloat16)
                       for k, v in words.items()},
            **{k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
               for k, v in other.items()}}
    for src in (d_ref, d):
        got, extra = ckpt.restore(src, like)
        assert extra == {"s": 1}
        for k, v in words.items():
            t = got["params"][k]
            assert t.dtype == torch.bfloat16 and t.shape == v.shape, k
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  v.view(np.int16)), k
        for k, v in other.items():
            assert got[k].shape == v.shape and np.array_equal(
                got[k].numpy(), v), k
    wide, _ = ckpt.restore(d, {**like, "params": {
        k: torch.zeros(v.shape) for k, v in words.items()}})
    w = wide["params"]["w"]
    assert w.dtype == torch.float32 and torch.equal(
        w, tree["params"]["w"].float())
    back, _ = ref_ckpt.restore(d, ref_tree)
    assert back["params"]["w"].dtype == np.dtype("V2")
    assert back["params"]["w"].tobytes() == words["w"].tobytes()


# ---------------------------------------------------------------------------
# StageCheckpointer against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def road():
    """road_like(2000, seed=0) in both packages, tau 4, and the
    reference's uninterrupted estimate."""
    ref_e = ref_gen.road_like(2000, seed=0)
    e = EdgeList(ref_e.n_nodes, ref_e.src, ref_e.dst, ref_e.weight)
    want = RefCQ().estimate(ref_open_session(ref_e, tau=4))
    return ref_e, e, want


class _KeepRef(RefCkpt):
    def complete(self):   # keep the step directories for the comparison
        self.resume = False


class _Keep(StageCheckpointer):
    def complete(self):
        self.resume = False


def _cfg(fuse):
    return GraphEngineConfig(fuse_supersteps=fuse)


def _same_estimate(got, want):
    """The estimate's fields and the quotient's eccentricities; the final
    planes too when ``want`` carries them (the port's estimates do, the
    reference's do not)."""
    for f in ESTIMATE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.quotient_ecc, want.quotient_ecc)
    if getattr(want, "decomposition", None) is not None:
        for f in ("final_c", "final_pathw"):
            np.testing.assert_array_equal(
                getattr(got.decomposition, f),
                getattr(want.decomposition, f))


@pytest.mark.parametrize("backend,fuse", BACKENDS)
def test_stage_checkpoints_match_the_reference(road, tmp_path, backend,
                                               fuse):
    """Every stage boundary's step: the same leaves (planes, key, store),
    byte-identical arrays, equal manifest ``extra``; the save's reads are
    booked in checkpoint_syncs, outside the counted host reads."""
    ref_e, e, want = road
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "port")
    with ref_open_session(None, store=RefGraphStore(ref_e), tau=4) as rs:
        rs.checkpointer = _KeepRef(d_ref, store=rs.store, keep=0)
        RefCQ().estimate(rs)
    with open_session(None, _cfg(fuse), store=GraphStore(e, device=CPU),
                      tau=4, backend=backend) as sess:
        sess.checkpointer = _Keep(d, store=sess.store, keep=0)
        with guard.metered() as meter:
            got = ClusterQuotientEstimator().estimate(sess)
        saves = sess.checkpointer.saves
    _same_estimate(got, want)
    pm = got.pipeline
    assert meter.transfers == pm.total_host_syncs + pm.checkpoint_syncs
    # the 8 planes and the boundary's uncovered count, one read each
    assert pm.checkpoint_syncs == 9 * saves
    steps = sorted(os.listdir(d))
    assert steps == sorted(os.listdir(d_ref))
    assert len(steps) == saves == got.decomposition.metrics.stages >= 3
    for step in steps:
        with open(os.path.join(d, step, "manifest.json")) as f:
            man = json.load(f)
        with open(os.path.join(d_ref, step, "manifest.json")) as f:
            ref_man = json.load(f)
        assert man["extra"] == ref_man["extra"]
        assert man["step"] == ref_man["step"]
        assert man["leaves"] == ref_man["leaves"]
        assert list(man["leaves"])[:2] == ["key", "planes__d"]
        for meta in man["leaves"].values():
            a = np.load(os.path.join(d, step, meta["file"]))
            b = np.load(os.path.join(d_ref, step, meta["file"]))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _killed_then_resumed(e, d, k, backend, fuse, store=True):
    pg = PreemptionGuard()
    make = (lambda: GraphStore(e, device=CPU)) if store else (lambda: None)
    edges = None if store else e
    with open_session(edges, _cfg(fuse), store=make(), tau=4,
                      backend=backend, device="cpu", checkpoint_dir=d,
                      guard=pg) as sess:
        sess.checkpointer.preempt_after_stage = k
        with pytest.raises(Preempted) as info, pg:
            ClusterQuotientEstimator().estimate(sess)
        assert info.value.stage == k and sess.checkpointer.saves == k
    assert ckpt.latest_step(d) == k
    with open_session(edges, _cfg(fuse), store=make(), tau=4,
                      backend=backend, device="cpu", checkpoint_dir=d,
                      resume=True, guard=PreemptionGuard()) as sess:
        got = ClusterQuotientEstimator().estimate(sess)
        assert sess.checkpointer.restores == 1
    assert ckpt.latest_step(d) is None     # complete() cleared the steps
    return got


@pytest.mark.parametrize("backend,fuse", BACKENDS)
@pytest.mark.parametrize("k", [1, 2, "last"])
def test_kill_and_resume_is_byte_identical(road, tmp_path, k, backend, fuse):
    ref_e, e, want = road
    with open_session(e, _cfg(fuse), tau=4, backend=backend,
                      device="cpu") as sess:
        whole = ClusterQuotientEstimator().estimate(sess)
    _same_estimate(whole, want)
    last = whole.decomposition.metrics.stages
    got = _killed_then_resumed(e, str(tmp_path), last if k == "last" else k,
                               backend, fuse, store=(k != 2))
    _same_estimate(got, whole)


@pytest.mark.parametrize("backend,fuse", BACKENDS)
def test_store_restore_rebinds_the_backend(road, tmp_path, monkeypatch,
                                          backend, fuse):
    """A resume restores the store, which uploads its edges anew: the
    session's backend is rebound to the store's new arrays (no stale
    second copy of the edges), and the run still finishes identical."""
    ref_e, e, want = road
    d = str(tmp_path)
    pg = PreemptionGuard()
    with open_session(None, _cfg(fuse), store=GraphStore(e, device=CPU),
                      tau=4, backend=backend, checkpoint_dir=d,
                      guard=pg) as sess:
        sess.checkpointer.preempt_after_stage = 1
        with pytest.raises(Preempted), pg:
            ClusterQuotientEstimator().estimate(sess)
    bound = []
    for cls in (SingleDeviceBackend, KernelBackend):
        orig = cls.rebind

        def spy(self, src, dst, weight, _orig=orig):
            bound.append((self, src, dst, weight))
            return _orig(self, src, dst, weight)

        monkeypatch.setattr(cls, "rebind", spy)
    with open_session(None, _cfg(fuse), store=GraphStore(e, device=CPU),
                      tau=4, backend=backend, checkpoint_dir=d,
                      resume=True) as sess:
        opened = len(bound)
        got = ClusterQuotientEstimator().estimate(sess)
        assert sess.checkpointer.restores == 1
        assert len(bound) == opened + 1
        be, src, dst, weight = bound[-1]
        st = sess.store
        assert be is sess.backend
        assert src is st.src and dst is st.dst and weight is st.weight
        if backend == "single":
            assert sess.backend.src is st.src
    _same_estimate(got, want)


def test_port_finishes_a_run_the_reference_killed(road, tmp_path):
    ref_e, e, want = road
    d = str(tmp_path)
    pg = RefGuard()
    with ref_open_session(None, store=RefGraphStore(ref_e), tau=4,
                          checkpoint_dir=d, guard=pg) as rs:
        rs.checkpointer.preempt_after_stage = 2
        with pytest.raises(Exception) as info, pg:
            RefCQ().estimate(rs)
        assert type(info.value).__name__ == "Preempted"
    with open_session(None, store=GraphStore(e, device=CPU), tau=4,
                      backend="kernel", checkpoint_dir=d,
                      resume=True) as sess:
        got = ClusterQuotientEstimator().estimate(sess)
        assert sess.checkpointer.restores == 1
    _same_estimate(got, want)


def test_divergent_resume_and_unguarded_kill_are_refused(road, tmp_path):
    ref_e, e, want = road
    d = str(tmp_path)
    with open_session(e, tau=4, device="cpu", backend="single") as sess:
        sess.checkpointer = _Keep(d)
        ClusterQuotientEstimator().estimate(sess)
    with open_session(e, tau=5, device="cpu", backend="single",
                      checkpoint_dir=d, resume=True) as sess:
        with pytest.raises(ValueError, match="tau"):
            ClusterQuotientEstimator().estimate(sess)
    with open_session(e, tau=4, device="cpu", backend="single",
                      checkpoint_dir=str(tmp_path / "x")) as sess:
        sess.checkpointer.preempt_after_stage = 1
        with pytest.raises(RuntimeError, match="PreemptionGuard"):
            ClusterQuotientEstimator().estimate(sess)
    # one-shot mode has no stage boundary: the checkpointer saves nothing
    with open_session(e, GraphEngineConfig(mode="oneshot"), tau=4,
                      device="cpu", backend="single",
                      checkpoint_dir=str(tmp_path / "o")) as sess:
        ClusterQuotientEstimator().estimate(sess)
        assert sess.checkpointer.saves == 0


# ---------------------------------------------------------------------------
# the paper-graph arch, its cell and the examples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_paper_graph_config_matches_reference(smoke):
    """Every field the two configs share is equal, but ``backend``, whose
    default is each package's own accelerated kind (the port's ``kernel``
    is the counterpart of the reference's Pallas backend)."""
    cfg, ref = get_arch("paper-graph", smoke=smoke), ref_get_arch(
        "paper-graph", smoke=smoke)
    assert type(cfg).__name__ == type(ref).__name__ == "GraphEngineConfig"
    shared = {f.name for f in dataclasses.fields(cfg)} & {
        f.name for f in dataclasses.fields(ref)}
    assert shared >= {"name", "family", "tau_fraction", "gamma", "variant",
                      "delta_init", "max_stages", "max_steps_per_phase",
                      "use_cluster2", "seed", "autotune", "fuse_supersteps",
                      "mode", "deterministic"}
    for f in sorted(shared - {"backend"}):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.family == "graph" and cfg.backend == "kernel"
    if smoke:
        assert (cfg.tau_fraction, cfg.max_stages) == (2e-2, 16)


@pytest.mark.parametrize("kind", ["kernel", "single"])
def test_paper_graph_cell_superstep_matches_reference(kind):
    ref_e = ref_gen.road_like(3000, seed=1)
    e = EdgeList(ref_e.n_nodes, ref_e.src, ref_e.dst, ref_e.weight)
    cell = build_cell("paper-graph", "", device="cpu", n_nodes=3000,
                      avg_degree=6)
    assert cell.n_edges == 18000 > e.n_edges
    assert cell.shape == "n0M"
    assert build_cell("paper-graph", "n16M", device="cpu").n_edges == \
        5 * 2**24
    inputs = cell.inputs(e)
    assert int(inputs["edge_mask"].sum()) == e.n_edges
    assert inputs["src"].shape == (18000,)
    be = cell.backend(inputs, kind)
    s0 = cell.state(be, seed=3)
    s1, stats = cell.step_fn(s0, be, 1 << 20)
    assert stats.steps == 1 and s1.d.shape == (3000,)
    # the reference: one growth_loop superstep of edge_relax_ref on the
    # same planes and the unpadded edges
    rs = ref_state.EngineState(*[jnp.asarray(getattr(s0, f.name).numpy())
                                 for f in dataclasses.fields(s0)])
    rw0, rc, rp, frozen = ref_state.relay_planes(rs)
    src, dst, w = (jnp.asarray(x) for x in (ref_e.src, ref_e.dst,
                                            ref_e.weight))
    delta = jnp.int32(1 << 20)

    def relax(s):
        return edge_relax_ref(s.d[src], s.c[src], s.pathw[src], rw0[src],
                              rc[src], rp[src], w, dst, jnp.bool_(True),
                              delta, 3000)

    want, _ = ref_growth(rs, relax, frozen, delta, jnp.int32(0),
                         jnp.int32(1), "complete")
    for f in ("d", "c", "pathw"):
        np.testing.assert_array_equal(getattr(s1, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert not np.array_equal(s1.d.numpy(), s0.d.numpy())
    with pytest.raises(ValueError, match="more than"):
        build_cell("paper-graph", "", device="cpu", n_nodes=3000,
                   avg_degree=1).inputs(e)
    with pytest.raises(ValueError, match="nodes"):
        cell.inputs(EdgeList(5, [0], [1], [1]))
    with pytest.raises(KeyError):
        build_cell("paper-graph", "n8M", device="cpu")


def _run_reference_example(name, argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "examples", name),
                           run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


def _run_port_example(name, argv):
    out = io.StringIO()
    mod = runpy.run_path(os.path.join(REPO, "examples", name))
    with contextlib.redirect_stdout(out):
        rc = mod["main"](argv)
    return rc, out.getvalue().splitlines()


def _timeless(lines):
    """The lines with each row's seconds column dropped."""
    out = []
    for line in lines:
        parts = line.split()
        if len(parts) == 5 and parts[-1].replace(".", "").isdigit():
            parts = parts[:-1]
        out.append(" ".join(parts))
    return out


@pytest.fixture(scope="module")
def ref_quickstart():
    return _run_reference_example("quickstart.py", [])


@pytest.mark.parametrize("backend", ["kernel", "single"])
def test_quickstart_example_matches_reference(ref_quickstart, backend):
    rc, lines = _run_port_example("quickstart_torch.py",
                                  ["--device", "cpu", "--backend", backend])
    assert rc == 0
    assert lines == ref_quickstart
    assert "conservative: True" in lines[-1]


def test_diameter_pipeline_example_matches_reference():
    rc, lines = _run_port_example(
        "diameter_pipeline_torch.py", ["--scale", "0.05", "--device", "cpu"])
    assert rc == 0
    want = _run_reference_example("diameter_pipeline.py",
                                  ["--scale", "0.05"])
    assert _timeless(lines) == _timeless(want)
    assert len(lines) == 1 + 3 * 5

"""The port's autotuner against the JAX package's: the log2 buckets of its
stats pass (the reference's float32 path, held as a table of thresholds,
at every integer within 2^(k-10) of each 2^k), ``GraphStats`` and
``graph_signature`` on road, RMAT, mesh, heavy-weight (weights 2^k - 1,
2^k, 2^k + 1), isolated-node and empty graphs, ``derive_tuning``'s
graph-only fields (``tau``, ``tau_solve``, ``levels``, ``delta_init``,
``signature``) and the hub-skew doubling; the fields priced for the card
(``predicted_superstep_s``, ``fuse``, ``mode``); ``validate_tuning``'s
rejections; the cache and its file; the session's pin semantics; and an
autotuned session's estimate equal to the reference's autotuned session's
at a pinned mode. Every compared value is an integer or a string, so
every comparison is exact."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import json

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import GraphEngineConfig as RefCfg  # noqa: E402
from repro.core import autotune as ref_at  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.core import (KernelBackend, open_session,  # noqa: E402
                              resolve_engine_mode)
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.kernels.edge_relax.megakernel import \
    DEFAULT_K_FUSED  # noqa: E402
from repro_torch.launch import diameter as launcher  # noqa: E402
from repro_torch.runtime import roofline  # noqa: E402

CPU = torch.device("cpu")
GRAPH_ONLY = ("signature", "tau", "tau_solve", "levels", "delta_init")


@pytest.fixture(autouse=True)
def _fresh_cache():
    at.clear_cache()
    ref_at.clear_cache()
    yield
    at.clear_cache()
    ref_at.clear_cache()


def _ref(e: EdgeList) -> RefEdgeList:
    return RefEdgeList(e.n_nodes, e.src.copy(), e.dst.copy(),
                       e.weight.copy())


def _heavy_weights():
    """Weights 2^k - 1, 2^k, 2^k + 1 for every k (those in [1, 2^30)), on a
    path over some nodes, with 40 isolated nodes after them."""
    w = sorted({x for k in range(31) for x in (2**k - 1, 2**k, 2**k + 1)
                if 1 <= x < 2**30})
    m = len(w)
    src = np.arange(m, dtype=np.int32) % 50
    dst = (src + 1) % 50
    return EdgeList(90, src, dst, np.asarray(w, np.int32))


def _star(hub_in: int, n: int = 400):
    """A ring with one hub of ``hub_in`` extra in-edges (a skewed graph)."""
    r = np.arange(n, dtype=np.int32)
    src = np.concatenate([r, np.arange(1, hub_in + 1, dtype=np.int32) % n])
    dst = np.concatenate([(r + 1) % n, np.zeros(hub_in, np.int32)])
    w = np.random.default_rng(hub_in).integers(1, 100, src.shape[0])
    return EdgeList(n, src, dst, w.astype(np.int32))


GRAPHS = {
    "road_like(3000)": lambda: gen.road_like(3000, seed=0),
    "rmat social_like(11)": lambda: gen.social_like(11, seed=1),
    "social uniform 2^26": lambda: gen.social_like(
        10, 8, seed=2, weight_dist="uniform", high=2**26),
    "mesh bimodal": lambda: gen.grid_mesh(30, "bimodal", heavy_w=10**6,
                                          heavy_p=0.1, seed=0),
    "heavy weights, isolated nodes": _heavy_weights,
    "star hub": lambda: _star(600),
    "edgeless": lambda: EdgeList(5, *(np.zeros(0, np.int32),) * 3),
    "empty": lambda: EdgeList(0, *(np.zeros(0, np.int32),) * 3),
}


# ---------------------------------------------------------------------------
# the stats pass
# ---------------------------------------------------------------------------

def _ref_bucket(x: np.ndarray) -> np.ndarray:
    """The reference's bucket (``autotune.py``'s ``lg`` inside
    ``_stats_pass``), on XLA's CPU."""
    f = jnp.maximum(jnp.asarray(x), 1).astype(jnp.float32)
    return np.asarray(jnp.clip(jnp.floor(jnp.log2(f)).astype(jnp.int32),
                               0, at.N_BUCKETS - 1))


@pytest.mark.parametrize("ks", [range(1, 11), range(11, 21), range(21, 26),
                                range(26, 29), range(29, 32)])
def test_bucket_thresholds_match_reference(ks):
    """Every integer within 2^(k-10) + 4 of 2^k gets the reference's
    bucket, and so do the ends of each window's neighbourhood."""
    bounds = torch.tensor(at.BUCKET_THRESHOLDS, dtype=torch.int64)
    for k in ks:
        w = 2**max(k - 10, 0) + 4
        x = np.arange(max(2**k - w, 0), min(2**k + w, 2**31 - 1) + 1,
                      dtype=np.int64)
        hist = at._hist(torch.from_numpy(x), bounds).numpy()
        expect = np.bincount(_ref_bucket(x.astype(np.int32)),
                             minlength=at.N_BUCKETS)
        np.testing.assert_array_equal(hist, expect, err_msg=f"k={k}")


def test_bucket_thresholds_are_the_reference_float_path():
    """Each threshold is the least integer of its bucket on the reference's
    path: it lands in bucket k, the integer before it in k - 1."""
    t = np.asarray(at.BUCKET_THRESHOLDS, np.int64)
    assert len(t) == 30 and (np.diff(t) > 0).all()
    np.testing.assert_array_equal(_ref_bucket(t.astype(np.int32)),
                                  np.arange(1, 31))
    np.testing.assert_array_equal(_ref_bucket((t - 1).astype(np.int32)),
                                  np.arange(0, 30))
    # the places where the float path and the integer bit length part
    assert _ref_bucket(np.array([8192], np.int32))[0] == 12
    assert _ref_bucket(np.array([2**21 - 1], np.int32))[0] == 21


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_stats_and_signature_match_reference(name):
    e = GRAPHS[name]()
    with guard.metered() as meter:
        s = at.compute_graph_stats(e, CPU)
    r = ref_at.compute_graph_stats(_ref(e))
    assert dataclasses.asdict(s) == dataclasses.asdict(r)
    assert at.graph_signature(s) == ref_at.graph_signature(r)
    # one packed read, the reference's reason (none for an empty graph)
    busy = e.n_nodes > 0 and e.n_edges > 0
    assert meter.transfers == int(busy)
    if busy:
        assert dict(meter.reason_counts) == {
            "autotune: packed degree/weight histograms": 1}
        assert sum(s.degree_hist) == e.n_nodes
        assert sum(s.weight_hist) == e.n_edges


# ---------------------------------------------------------------------------
# derive_tuning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau_fraction", [1e-3, 2e-2])
@pytest.mark.parametrize("name", sorted(set(GRAPHS) - {"empty"}))
def test_derive_tuning_graph_fields_match_reference(name, tau_fraction):
    e = GRAPHS[name]()
    rec = at.derive_tuning(at.compute_graph_stats(e, CPU), device=CPU,
                           tau_fraction=tau_fraction)
    ref = ref_at.derive_tuning(ref_at.compute_graph_stats(_ref(e)),
                               tau_fraction=tau_fraction)
    for f in GRAPH_ONLY:
        assert getattr(rec, f) == getattr(ref, f), f
    at.validate_tuning(rec, at.compute_graph_stats(e, CPU))


def test_hub_skew_doubles_tau():
    def tuned(e):
        s = at.compute_graph_stats(e, CPU)
        return s, at.derive_tuning(s, device=CPU, tau_fraction=0.1)

    s0, flat = tuned(_star(0, n=4000))
    s1, hub = tuned(_star(600, n=4000))
    assert s0.max_degree / max(s0.avg_degree, 1) <= at._HUB_SKEW
    assert s1.max_degree / max(s1.avg_degree, 1) > at._HUB_SKEW
    assert hub.tau == 2 * flat.tau
    ref = ref_at.derive_tuning(ref_at.compute_graph_stats(
        _ref(_star(600, n=4000))), tau_fraction=0.1)
    assert ref.tau == hub.tau


def _stats(n, e):
    return at.GraphStats(n, e, e / max(n, 1), 6, 1, 50, 100, 50 * e,
                         (0,) * 32, (0,) * 6 + (e,) + (0,) * 25)


@pytest.mark.parametrize("n,e", [(1_890_815, 11_344_878), (262_144, 1_572_852),
                                 (3000, 17_988)])
def test_priced_fields(n, e):
    """The superstep's price is the byte bound of one relax pass at the
    card's HBM rate; fuse is the megakernel's depth on a CUDA kernel
    backend only; mode is the reference's formula."""
    s = _stats(n, e)
    rec = at.derive_tuning(s, backend="kernel", device="cuda")
    assert rec.predicted_superstep_s == (
        (4 * (n + 1) + 8 * e + 36 * n) / roofline.HBM_BYTES_PER_S)
    assert roofline.relax_pass_bytes(n, e) == 4 * (n + 1) + 8 * e + 36 * n
    assert rec.fuse == DEFAULT_K_FUSED == 8
    assert at.derive_tuning(s, backend="kernel", device="cpu").fuse == 0
    assert at.derive_tuning(s, backend="single", device="cuda").fuse == 0
    logn = np.log(n)
    s_hat = max(1, int(np.ceil(np.log2(max(n / (8 * rec.tau * logn), 2)))))
    oneshot = s_hat * at._HOST_SYNC_S > int(np.sqrt(n)) * \
        rec.predicted_superstep_s
    assert rec.mode == ("oneshot" if oneshot else "stages")


def test_full_size_record():
    """At the CAL road graph's size the record asks for a two-level
    cascade at tau 130 with the solve budget 1,024."""
    rec = at.derive_tuning(_stats(1_890_815, 11_344_878), device="cuda")
    assert (rec.tau, rec.tau_solve, rec.levels) == (130, 1024, 2)
    assert rec.mode == "stages"


def test_mode_follows_the_host_read_price(monkeypatch):
    s = _stats(1_890_815, 11_344_878)
    monkeypatch.setattr(at, "_HOST_SYNC_S", 1.0)
    assert at.derive_tuning(s).mode == "oneshot"
    monkeypatch.setattr(at, "_HOST_SYNC_S", 0.0)
    assert at.derive_tuning(s).mode == "stages"


def test_fuse_needs_int32_counts():
    big = _stats(2**31 // 9 + 1, 10)
    assert at.derive_tuning(big, device="cuda").fuse == 0
    assert at.derive_tuning(_stats(2**31 // 9 - 1, 10),
                            device="cuda").fuse == 8


# ---------------------------------------------------------------------------
# validate_tuning
# ---------------------------------------------------------------------------

BAD = {
    "tau 0": dict(tau=0),
    "tau above n": dict(tau=10**6),
    "tau_solve 1": dict(tau_solve=1),
    "levels 5": dict(levels=5),
    "levels -1": dict(levels=-1),
    "delta_init 0": dict(delta_init=0),
    "delta_init 2^30": dict(delta_init=2**30),
    "fuse -1": dict(fuse=-1),
    "mode auto": dict(mode="auto"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_tuning_rejects(case):
    s = at.compute_graph_stats(gen.road_like(2000, seed=0), CPU)
    good = at.derive_tuning(s, device=CPU)
    at.validate_tuning(good, s)
    with pytest.raises(at.AutotuneError):
        at.validate_tuning(dataclasses.replace(good, **BAD[case]), s)


def test_validate_tuning_rejects_fuse_past_int32():
    s = _stats(2**28, 10)
    rec = at.derive_tuning(s, device="cuda")
    assert rec.fuse == 0   # 2^28 * 9 >= 2^31
    with pytest.raises(at.AutotuneError, match="int32"):
        at.validate_tuning(dataclasses.replace(rec, fuse=8), s)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_get_tuning_caches_by_signature_backend_and_device():
    e = gen.road_like(1500, seed=0)
    a = at.get_tuning(e, device=CPU)
    b = at.get_tuning(e, device=CPU)
    assert a is b and at.TUNE_EVENTS == {"hits": 1, "misses": 1}
    at.get_tuning(e, backend="single", device=CPU)
    assert at.TUNE_EVENTS["misses"] == 2
    assert sorted(at._CACHE) == sorted(
        f"{a.signature}:{k}:cpu" for k in ("kernel", "single"))


def test_cache_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    assert at.load_cache() == 0   # absent file
    e = gen.road_like(1500, seed=1)
    rec = at.get_tuning(e, device=CPU, record=True)   # writes the env's file
    payload = json.loads(path.read_text())
    assert list(payload) == [f"{rec.signature}:kernel:cpu"]
    assert set(payload[f"{rec.signature}:kernel:cpu"]) == {
        f.name for f in dataclasses.fields(at.TuningRecord)}
    at.clear_cache()
    assert at.load_cache() == 1
    assert at.get_tuning(e, device=CPU) == rec
    assert at.TUNE_EVENTS == {"hits": 1, "misses": 0}
    other = tmp_path / "other.json"
    assert at.save_cache(str(other)) == str(other) and other.exists()
    # without the variable: the port's own file, never the reference's
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    assert at._default_cache_path().endswith(
        "/.cache/repro_torch_autotune.json")


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def test_session_autotune_defaults_and_pins():
    e = gen.road_like(3000, seed=2)
    rec = at.get_tuning(e, device=CPU)
    s = open_session(e, GraphEngineConfig(autotune="auto", mode="auto"),
                     device=CPU)
    assert s.tuning == rec
    assert (s.tau, s.tau_solve) == (rec.tau, rec.tau_solve)
    assert s.cfg.delta_init == str(rec.delta_init)
    assert s.cfg.mode == rec.mode == resolve_engine_mode("auto", rec)
    # explicit knobs win
    p = open_session(e, GraphEngineConfig(delta_init="7", mode="stages"),
                     tau=9, tau_solve=33, device=CPU, autotune="auto")
    assert (p.tau, p.tau_solve, p.cfg.delta_init, p.cfg.mode) == (
        9, 33, "7", "stages")
    # off: no record, auto mode resolves to stages
    o = open_session(e, GraphEngineConfig(mode="auto"), device=CPU)
    assert o.tuning is None and o.cfg.mode == "stages"
    with pytest.raises(ValueError, match="autotune"):
        open_session(e, device=CPU, autotune="always")


def test_session_autotune_fuse_and_prebuilt_backend():
    """The record's fuse reaches the kernel backend (0 off the card); a
    nonzero fuse_supersteps and a prebuilt backend always win."""
    e = gen.road_like(2000, seed=3)
    s = open_session(e, device=CPU, autotune="auto")
    assert s.tuning.fuse == 0 and s.backend.fuse == 0
    f = open_session(e, GraphEngineConfig(fuse_supersteps=4), device=CPU,
                     autotune="auto")
    assert f.backend.fuse == 4
    be = KernelBackend(e, device=CPU, fuse=2)
    b = open_session(e, backend=be, autotune="auto")
    assert b.backend is be and b.tuning is not None


def test_degenerate_graphs_are_not_tuned():
    for e in (GRAPHS["edgeless"](), GRAPHS["empty"]()):
        s = open_session(e, device=CPU, autotune="auto")
        assert s.tuning is None


@pytest.mark.parametrize("backend", ["single", "kernel"])
@pytest.mark.parametrize("make", [lambda g: g.road_like(3000, seed=0),
                                  lambda g: g.social_like(10, seed=0)])
def test_autotuned_session_matches_reference(make, backend):
    """At a pinned mode ("stages"), an autotuned session's default query
    (the record's cascade, or the flat pipeline) equals the reference's
    autotuned session's, field for field."""
    e = make(gen)
    sess = open_session(e, GraphEngineConfig(backend=backend), device=CPU,
                        autotune="auto")
    ref = ref_open_session(_ref(e), RefCfg(), autotune="auto")
    for f in ("tau", "tau_solve"):
        assert getattr(sess, f) == getattr(ref, f)
    assert sess.cfg.delta_init == ref.cfg.delta_init
    a, r = sess.estimate(), ref.estimate()
    assert a.method == r.method
    for f in ("phi_approx", "phi_quotient", "radius", "n_clusters",
              "growing_steps", "n_stages", "delta_end", "connected"):
        assert getattr(a, f) == getattr(r, f), f
    assert a.pipeline.level_clusters == r.pipeline.level_clusters
    np.testing.assert_array_equal(a.quotient_ecc, r.quotient_ecc)


def test_launcher_autotune(capsys):
    e = launcher.build_graph("road", 3000, 0)
    assert launcher.main(["--graph", "road", "--n", "3000", "--device",
                          "cpu", "--autotune", "auto"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = at.derive_tuning(at.compute_graph_stats(e, CPU), device=CPU)
    assert out["tuning"] == dataclasses.asdict(rec)
    assert out["tau"] == rec.tau
    if rec.levels:
        assert out["cascade_levels"] <= rec.levels
        assert out["tau_solve"] == rec.tau_solve
    ref = ref_open_session(_ref(e), RefCfg(), autotune="auto").estimate()
    assert out["phi_approx"] == ref.phi_approx


def test_pooled_autotune_tunes_the_padded_edges():
    """A pooled session is tuned on its padded edges, as the reference's
    is: 1,200 self-loops at node 0 pass the hub-skew test, so the smaller
    graph's tau doubles; the records equal the reference's."""
    from repro.core import SessionPool as RefPool
    from repro_torch.core import SessionPool

    a = gen.road_like(3000, seed=0)
    keep = np.sort(np.random.default_rng(0).permutation(a.n_edges)
                   [:a.n_edges - 1200])
    b = EdgeList(a.n_nodes, a.src[keep], a.dst[keep], a.weight[keep])
    cfg = GraphEngineConfig(autotune="auto")
    with SessionPool(cfg, device=CPU) as pool, \
            RefPool(RefCfg(autotune="auto")) as ref_pool:
        tuned = [pool.open(g, e_pad=a.n_edges) for g in (a, b)]
        refs = [ref_pool.open(_ref(g), e_pad=a.n_edges)
                for g in (a, b)]
    for s, r in zip(tuned, refs):
        for f in GRAPH_ONLY:
            assert getattr(s.tuning, f) == getattr(r.tuning, f), f
        assert s.tau == r.tau
    assert tuned[1].tau == 2 * tuned[0].tau
    solo = at.derive_tuning(at.compute_graph_stats(b, CPU), device=CPU)
    assert solo.tau == tuned[0].tau

"""Dynamic updates in the port against the JAX package: ``UpdateBatch`` and
its refusals (a bad batch leaves the store untouched), the witness forest
(``_forest_repair``) on random planes, the quotient merge and the
incremental quotient against a full recompute, and the whole path —
after every batch of a seeded trace, under the insert, mixed and delete
mixes, on the plain and kernel backends, unpooled and pooled: the planes,
``UpdateReport`` (seconds aside), ``DynamicMetrics``, the maintained
estimate and the ``IntervalEstimator`` bracket equal the reference's, and
the bracket holds scipy's exact diameter. Then the disconnecting-deletion,
capped-repair and ``rebuild_fraction`` cases, the session's caches, the
serve launcher's replay, ``KernelBackend.rebind``'s CSR (the store's inert
slots in no row) and an import of the dynamic path with JAX blocked.
Every compared value is an integer, so every comparison is exact."""
import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

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
from repro.core import DynamicQuotientEstimator as RefDyn  # noqa: E402
from repro.core import IntervalEstimator as RefInterval  # noqa: E402
from repro.core import SessionPool as RefPool  # noqa: E402
from repro.core import UpdateBatch as RefBatch  # noqa: E402
from repro.core import dynamic as ref_dyn  # noqa: E402
from repro.core import open_session as ref_open  # noqa: E402
from repro.core import quotient as ref_q  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.core import (DynamicQuotientEstimator,  # noqa: E402
                              IntervalEstimator, KernelBackend, SessionPool,
                              UpdateBatch, open_session)
from repro_torch.core import dynamic as dyn  # noqa: E402
from repro_torch.core import quotient as q  # noqa: E402
from repro_torch.graph import EdgeStore, temporal_trace  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList, to_scipy_csr  # noqa: E402
from repro_torch.kernels.edge_relax.ops import build_relax_graph  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]
MIXES = {"insert": (1.0, 0.0, 0.0), "mixed": (0.4, 0.4, 0.2),
         "delete": (0.1, 0.1, 0.8)}
EST_FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
              "growing_steps", "n_stages", "delta_end", "connected",
              "lower", "upper")
PM_FIELDS = ("quotient_syncs", "n_quotient_edges", "solve_supersteps")
REF_METRICS = [f.name for f in dataclasses.fields(ref_dyn.DynamicMetrics)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(edges) -> int:
    d = shortest_path(to_scipy_csr(edges), method="D", directed=False)
    fin = d[np.isfinite(d)]
    return int(fin.max()) if len(fin) else 0


def _report(rep) -> dict:
    d = dataclasses.asdict(rep)
    d.pop("seconds")
    return d


def _metrics(m) -> dict:
    return {k: getattr(m, k) for k in REF_METRICS}


def _estimate(e) -> tuple:
    return (tuple(getattr(e, f) for f in EST_FIELDS),
            tuple(getattr(e.pipeline, f) for f in PM_FIELDS),
            None if e.quotient_ecc is None else
            np.asarray(e.quotient_ecc, np.int64).tolist())


# ---------------------------------------------------------------------------
# UpdateBatch and staging
# ---------------------------------------------------------------------------


def test_update_batch_constructors_and_refusals():
    for make in (lambda m: m.inserts([0, 2], [1, 3], [5, 6]),
                 lambda m: m.reweights([0], [1], [9], symmetric=False),
                 lambda m: m.deletes([4, 5], [6, 7]),
                 lambda m: m.merge([m.inserts([0], [1], [5]),
                                    m.deletes([2], [3])]),
                 lambda m: m.merge([])):
        a, b = make(RefBatch), make(UpdateBatch)
        assert a.n_events == b.n_events
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, f.name),
                                          getattr(a, f.name))
    for kw, msg in ((dict(insert_src=[0], insert_dst=[1], insert_weight=[]),
                     "insert arrays length mismatch"),
                    (dict(reweight_src=[0], reweight_dst=[],
                          reweight_weight=[1]),
                     "reweight arrays length mismatch"),
                    (dict(delete_src=[0]), "delete arrays length mismatch"),
                    (dict(insert_src=[0], insert_dst=[1],
                          insert_weight=[2**30]), r"\[1, 2\^30\)")):
        for m in (RefBatch, UpdateBatch):
            with pytest.raises(ValueError, match=msg):
                m(**kw)


@pytest.mark.parametrize("bad,msg", [
    (lambda m: m.deletes([0], [15]), "missing edge"),
    (lambda m: m.reweights([0], [15], [3]), "missing edge"),
    (lambda m: m.inserts([0], [99], [3]), "out of range"),
    (lambda m: m.merge([m.deletes([0], [1]), m.reweights([0], [1], [2])]),
     "at most one reweight/delete"),
])
def test_bad_batch_leaves_the_store_untouched(bad, msg):
    """The reference and the port refuse the same batch with the same
    message, and the port's store (mirrors, slots, free list, device
    arrays) is as it was."""
    ref = ref_open(ref_gen.grid_mesh(4, "unit"), tau=2)
    sess = open_session(gen.grid_mesh(4, "unit"), tau=2, device=CPU)
    sess.apply_updates(UpdateBatch.deletes([5], [6]))
    ref.apply_updates(RefBatch.deletes([5], [6]))
    store = sess.dynamic.store
    before = (store.h_src.copy(), store.h_weight.copy(), store.valid.copy(),
              dict(store.slot_of), list(store.free), store.src.clone(),
              store.scatters, sess.dynamic.metrics.batches)
    with pytest.raises(ValueError, match=msg):
        ref.apply_updates(bad(RefBatch))
    with pytest.raises(ValueError, match=msg):
        sess.apply_updates(bad(UpdateBatch))
    after = (store.h_src, store.h_weight, store.valid, store.slot_of,
             store.free, store.src, store.scatters,
             sess.dynamic.metrics.batches)
    for a, b in zip(before, after):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert not store._pending


def test_noop_batches_and_a_closed_session():
    sess = open_session(gen.grid_mesh(4, "unit"), tau=2, device=CPU)
    rep = sess.apply_updates(UpdateBatch())
    assert rep.action == "noop" and rep.supersteps == 0
    u, v = int(sess.edges.src[0]), int(sess.edges.dst[0])
    rep = sess.apply_updates(UpdateBatch.inserts([u], [v], [5]))
    assert rep.action == "noop" and rep.noops == 2   # heavier parallel edge
    assert sess.dynamic.store.scatters == 0
    sess.close()
    assert sess.dynamic is None
    with pytest.raises(RuntimeError, match="closed"):
        sess.apply_updates(UpdateBatch())


# ---------------------------------------------------------------------------
# the witness forest and the quotient merge, alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forest_repair_matches_the_reference(seed):
    """Random certificates (centers at 0, some INF, some at or past 2^30)
    and weights (some at 2^30 - 1, so sums saturate) over a random
    multigraph with self-loops."""
    rng = np.random.default_rng(seed)
    n, e = 300, 1500
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.integers(1, 60, e).astype(np.int32)
    w[rng.random(e) < 0.05] = 2**30 - 1
    centers = rng.choice(n, 12, replace=False)
    fc = centers[rng.integers(0, 12, n)].astype(np.int32)
    fc[centers] = centers
    fp = rng.integers(1, 400, n).astype(np.int32)
    fp[rng.random(n) < 0.05] = 2**30 + 5
    fp[rng.random(n) < 0.05] = 2**31 - 1
    fp[centers] = 0
    rounds = dyn._pointer_rounds(n)
    ra, rf = ref_dyn._forest_repair(*(jnp.asarray(x) for x in
                                      (src, dst, w, fc, fp)),
                                    n=n, k_rounds=rounds)
    pa, pf = dyn._forest_repair(*(torch.from_numpy(x) for x in
                                  (src, dst, w, fc, fp)),
                                n=n, k_rounds=rounds)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
    assert pf.dtype == torch.int32 and 0 < int(pa.sum()) < n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_quotient_kernel_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    n, m, f = 64, 300, 120
    cs = rng.integers(0, n + 1, m).astype(np.int32)
    cd = rng.integers(0, n + 1, m).astype(np.int32)
    cw = rng.integers(1, 10**9, m).astype(np.int64)
    cw[rng.random(m) < 0.2] = int(q.INF64)
    fs = rng.integers(0, n, f).astype(np.int32)
    fd = rng.integers(0, n, f).astype(np.int32)
    fw = rng.integers(1, 10**9, f).astype(np.int64)
    fw[rng.random(f) < 0.3] = 2**63 - 1
    dirty = rng.random(n) < 0.3
    with jax.experimental.enable_x64():
        want = ref_q._merge_quotient_kernel(
            *(jnp.asarray(x) for x in (cs, cd, cw, fs, fd, fw, dirty)), n=n)
        want = [np.asarray(x) for x in want]
    got = q._merge_quotient_kernel(
        *(torch.from_numpy(x) for x in (cs, cd, cw, fs, fd, fw, dirty)), n=n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_incremental_quotient_matches_a_full_recompute():
    """After every batch whose cluster set is unchanged, the merged
    quotient gives the full pass's estimate, k, m and weight sum (the
    merge's max weight is the coalesced one, at most the full pass's),
    and the counters equal the reference's."""
    g, rg = gen.random_geometric(400, seed=7), ref_gen.random_geometric(
        400, seed=7)
    sess = open_session(g, tau=6, device=CPU)
    ref = ref_open(rg, tau=6)
    sess.estimate(DynamicQuotientEstimator())
    ref.estimate(RefDyn())
    st = sess.dynamic
    incremental = 0
    for b, rb in zip(temporal_trace(g, 3, events_per_batch=10, seed=13),
                     ref_gen.temporal_trace(rg, 3, events_per_batch=10,
                                            seed=13)):
        sess.apply_updates(b)
        ref.apply_updates(rb)
        if st.quotient_stale:
            continue
        incremental += 1
        inc = sess.estimate(DynamicQuotientEstimator())
        ref_inc = ref.estimate(RefDyn())
        assert st.dq_counters == ref.dynamic.dq_counters
        assert _estimate(inc) == _estimate(ref_inc)
        k_inc, m_inc, wmax_inc, wsum_inc = st.dq_counters
        st.quotient_stale, st.solution, st.dq = True, None, None
        full = sess.estimate(DynamicQuotientEstimator())
        k_full, m_full, wmax_full, wsum_full = st.dq_counters
        assert (inc.phi_approx, inc.connected) == (full.phi_approx,
                                                   full.connected)
        assert (k_inc, m_inc, wsum_inc) == (k_full, m_full, wsum_full)
        assert wmax_inc <= wmax_full
        np.testing.assert_array_equal(inc.quotient_ecc, full.quotient_ecc)
    assert incremental >= 2


# ---------------------------------------------------------------------------
# the whole path, batch for batch
# ---------------------------------------------------------------------------

TAU = 5
BATCHES = 3


def _graphs(m, name):
    if name == "geometric":
        return [m.random_geometric(260, seed=4)]
    if name == "social":
        return [m.social_like(10, seed=1)]
    return [m.random_geometric(260, seed=4), m.road_like(240, seed=5)]


def _events(name):
    return 40 if name == "social" else 16


def _open(name, graphs, cfg, pool_cls, **kw):
    if name != "pooled":
        return None, [(ref_open if pool_cls is RefPool else open_session)(
            graphs[0], cfg, tau=TAU, **kw)]
    pool = pool_cls(cfg, **kw)
    e_pad = max(g.n_edges for g in graphs) + 300
    return pool, [pool.open(g, tau=TAU, e_pad=e_pad) for g in graphs]


def _replay(sessions, traces, dyn_est, interval):
    """Per batch and session: planes, report, metrics, estimates and the
    bracket, with scipy's exact diameter."""
    rows = []
    for b in range(BATCHES):
        for s, trace in zip(sessions, traces):
            rep = s.apply_updates(trace[b])
            est = s.estimate(dyn_est())
            iv = s.estimate(interval())
            dec = s.dynamic.dec
            rows.append(dict(
                report=_report(rep), fc=dec.final_c.tolist(),
                fp=dec.final_pathw.tolist(),
                metrics=_metrics(s.dynamic.metrics), estimate=_estimate(est),
                bracket=(iv.lower, iv.upper, iv.connected),
                exact=_exact(s.edges)))
    return rows


@functools.lru_cache(maxsize=None)
def _reference_run(name, mix):
    graphs = _graphs(ref_gen, name)
    p = MIXES[mix]
    traces = [ref_gen.temporal_trace(g, BATCHES,
                                     events_per_batch=_events(name),
                                     p_insert=p[0], p_reweight=p[1],
                                     p_delete=p[2], seed=i)
              for i, g in enumerate(graphs)]
    pool, sessions = _open(name, graphs, RefCfg(), RefPool)
    rows = _replay(sessions, traces, RefDyn, RefInterval)
    if pool is not None:
        pool.close()
    return rows


@pytest.mark.parametrize("backend", ["single", "kernel"])
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("name", ["geometric", "social", "pooled"])
def test_dynamic_path_matches_the_reference(name, mix, backend):
    graphs = _graphs(gen, name)
    p = MIXES[mix]
    traces = [temporal_trace(g, BATCHES, events_per_batch=_events(name),
                             p_insert=p[0], p_reweight=p[1], p_delete=p[2],
                             seed=i)
              for i, g in enumerate(graphs)]
    pool, sessions = _open(name, graphs, GraphEngineConfig(backend=backend),
                           SessionPool, device=CPU)
    rows = _replay(sessions, traces, DynamicQuotientEstimator,
                   IntervalEstimator)
    want = _reference_run(name, mix)
    assert len(rows) == len(want) == BATCHES * len(graphs)
    for i, (got, ref) in enumerate(zip(rows, want)):
        for key in got:
            assert got[key] == ref[key], (i, key)
        lower, upper, _ = got["bracket"]
        assert lower <= got["exact"] <= upper
    actions = {r["report"]["action"] for r in rows}
    assert actions <= {"relax", "repair", "rebuild"}
    if pool is not None:
        pool.close()


def test_disconnecting_deletions_match_the_reference():
    """Cutting the only bridge, then isolating a node: the brackets are
    the reference's, flag the graph disconnected and hold the largest
    finite distance."""
    u = np.array([0, 1, 2, 3, 4, 5, 2], np.int32)
    v = np.array([1, 2, 0, 4, 5, 3, 3], np.int32)
    w = np.array([5, 5, 5, 7, 7, 7, 100], np.int32)
    ref = ref_open(RefEdgeList.from_undirected(6, u, v, w), tau=2)
    sess = open_session(EdgeList.from_undirected(6, u, v, w), tau=2,
                        device=CPU)
    for cut in (None, ([2], [3]), ([0], [1]), ([0], [2])):
        if cut is not None:
            assert _report(sess.apply_updates(UpdateBatch.deletes(*cut))) \
                == _report(ref.apply_updates(RefBatch.deletes(*cut)))
        iv, riv = sess.estimate(IntervalEstimator()), ref.estimate(
            RefInterval())
        assert (iv.lower, iv.upper, iv.connected) == (riv.lower, riv.upper,
                                                      riv.connected)
        assert iv.lower <= _exact(sess.edges) <= iv.upper
        assert iv.connected == (cut is None)


def test_capped_repair_matches_the_reference():
    """``tighten_cap=1, regrow_cap=1``: cutting the largest cluster's
    center out of a unit cycle leaves dead nodes the capped regrow cannot
    reach; they become singletons, as in the reference."""
    n = 48
    u = np.arange(n, dtype=np.int32)
    ones = np.ones(n, np.int32)
    ref = ref_open(RefEdgeList.from_undirected(n, u, (u + 1) % n, ones),
                   tau=1)
    sess = open_session(EdgeList.from_undirected(n, u, (u + 1) % n, ones),
                        tau=1, device=CPU)
    sess.estimate(DynamicQuotientEstimator())
    ref.estimate(RefDyn())
    dec = sess.dynamic.dec
    vals, counts = np.unique(dec.final_c, return_counts=True)
    c = int(vals[counts.argmax()])
    assert counts.max() >= 4
    cut = ([c, c], [(c - 1) % n, (c + 1) % n])
    rep = sess.apply_updates(UpdateBatch.deletes(*cut), tighten_cap=1,
                             regrow_cap=1)
    rref = ref.apply_updates(RefBatch.deletes(*cut), tighten_cap=1,
                             regrow_cap=1)
    assert _report(rep) == _report(rref)
    assert rep.action == "repair" and rep.new_singletons > 0
    np.testing.assert_array_equal(sess.dynamic.dec.final_c,
                                  ref.dynamic.dec.final_c)
    np.testing.assert_array_equal(sess.dynamic.dec.final_pathw,
                                  ref.dynamic.dec.final_pathw)
    iv, riv = sess.estimate(IntervalEstimator()), ref.estimate(RefInterval())
    assert (iv.lower, iv.upper, iv.connected) == (riv.lower, riv.upper,
                                                  riv.connected)
    assert not iv.connected and iv.lower <= _exact(sess.edges) <= iv.upper
    assert _metrics(sess.dynamic.metrics) == _metrics(ref.dynamic.metrics)


@pytest.mark.parametrize("fraction,action", [(0.0, "rebuild"),
                                             (1.0, "repair")])
def test_rebuild_fraction_matches_the_reference(fraction, action):
    g, rg = gen.random_geometric(200, seed=2), ref_gen.random_geometric(
        200, seed=2)
    pairs = sorted({(int(a), int(b)) for a, b in zip(g.src, g.dst) if a < b})
    dels = pairs[: len(pairs) // 4]
    us, vs = [p[0] for p in dels], [p[1] for p in dels]
    sess = open_session(g, tau=4, device=CPU, rebuild_fraction=fraction)
    ref = ref_open(rg, tau=4, rebuild_fraction=fraction)
    rep = sess.apply_updates(UpdateBatch.deletes(us, vs))
    assert _report(rep) == _report(ref.apply_updates(RefBatch.deletes(us,
                                                                      vs)))
    assert rep.action == action
    assert _metrics(sess.dynamic.metrics) == _metrics(ref.dynamic.metrics)
    np.testing.assert_array_equal(sess.dynamic.dec.final_c,
                                  ref.dynamic.dec.final_c)
    iv = sess.estimate(IntervalEstimator())
    assert iv.lower <= _exact(sess.edges) <= iv.upper
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="rebuild_fraction"):
            open_session(g, device=CPU, rebuild_fraction=bad)
    pool = SessionPool(device=CPU, rebuild_fraction=fraction)
    assert pool.open(g, tau=4).rebuild_fraction == fraction


def test_session_caches_track_the_mutations():
    """Deleting every edge leaves the empty graph ([0, 0]); heavy inserts
    into a near-empty session reach the SSSP estimators' dtype choice."""
    u = np.array([0, 1], np.int32)
    sess = open_session(EdgeList.from_undirected(3, u, u + 1,
                                                 np.array([5, 7], np.int32)),
                        tau=2, device=CPU)
    sess.apply_updates(UpdateBatch.deletes([0, 1], [1, 2]))
    assert sess.n_edges == 0 and sess.edges.n_edges == 0
    iv = sess.estimate(IntervalEstimator())
    assert not iv.connected and iv.lower == iv.upper == 0
    heavy = 2**30 - 1
    sess2 = open_session(EdgeList.from_undirected(
        6, np.array([0], np.int32), np.array([1], np.int32),
        np.array([1], np.int32)), tau=2, device=CPU)
    chain = np.arange(5, dtype=np.int32)
    sess2.apply_updates(UpdateBatch.inserts(chain, chain + 1,
                                            np.full(5, heavy, np.int32)))
    assert sess2.max_weight == heavy and sess2.n_edges == 10
    iv2 = sess2.estimate(IntervalEstimator())
    exact = _exact(sess2.edges)
    assert exact == 4 * heavy + 1
    assert iv2.connected and iv2.lower <= exact <= iv2.upper


def test_update_metrics_and_the_cached_solve():
    g = gen.random_geometric(220, seed=3)
    sess = open_session(g, tau=4, device=CPU)
    assert sess.estimate().method == "cluster-quotient"
    with guard.metered() as meter:
        for b in temporal_trace(g, 3, events_per_batch=12, seed=2):
            sess.apply_updates(b)
    m = sess.dynamic.metrics
    assert m.batches == 3 and m.baseline_supersteps > 0
    assert meter.transfers == m.update_syncs + m.engine_syncs
    assert m.amortized_supersteps == pytest.approx(
        (m.update_supersteps + m.rebuild_supersteps) / 3)
    est = sess.estimate()
    assert est.method == "dynamic-quotient"
    with guard.metered() as meter:
        again = sess.estimate()
    assert meter.transfers == again.pipeline.total_host_syncs == 0
    assert again.phi_approx == est.phi_approx
    src, dst, w = sess.flat_device_edges()
    assert src is sess.dynamic.store.src and w is sess.dynamic.store.weight


# ---------------------------------------------------------------------------
# the kernel backend's CSR after rebind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [0, 8])
def test_rebind_keeps_inert_slots_out_of_the_csr(fuse):
    """The store's inert ``0 -> 0`` slots (a third of it) sort past
    ``row_ptr[n]``: the rows, long rows and out-CSR are those of the real
    edges alone, and a grow over them gives the plain CSR's planes."""
    g = gen.social_like(9, seed=3)       # RMAT: row 0 a hub
    store = EdgeStore(g, device=CPU)
    store.delete_edge(int(g.src[0]), int(g.dst[0]))
    store.flush()
    kb = KernelBackend(g, device=CPU, fuse=fuse)
    kb.rebind(store.src, store.dst, store.weight)
    got = kb.graph
    real = store.edge_list()
    plain = build_relax_graph(real.src, real.dst, real.weight, g.n_nodes, CPU)
    m = real.n_edges
    assert got.inert_tail and got.n_edges == store.capacity > m
    assert torch.equal(got.row_ptr, plain.row_ptr)
    assert torch.equal(got.src[:m], plain.src)
    assert torch.equal(got.w[:m], plain.w)
    assert torch.equal(got.long_rows, plain.long_rows)
    assert bool((got.src[m:] == 0).all() & (got.dst[m:] == 0).all())
    (gp, gd), (pp, pd) = got.out_csr(), plain.out_csr()
    assert torch.equal(gp, pp) and torch.equal(gd[:m], pd)
    want_be = KernelBackend(real, device=CPU, fuse=fuse)
    n = g.n_nodes
    fc = torch.arange(n, dtype=torch.int32) // 64 * 64
    fp = torch.where(fc == torch.arange(n, dtype=torch.int32), 0, 2**31 - 1)
    alive = fp == 0
    state = dyn._repair_state(fc, fp.to(torch.int32), alive, n,
                              confine=False)
    a, sa = kb.grow(state, 2**30, 0, 2**30, "complete")
    b, sb = want_be.grow(state, 2**30, 0, 2**30, "complete")
    assert sa.steps == sb.steps > 0
    for x, y in ((a.d, b.d), (a.c, b.c), (a.pathw, b.pathw)):
        assert torch.equal(x, y)
    assert kb.rebind_seconds > 0.0


# ---------------------------------------------------------------------------
# serve --update-trace, and the import without JAX
# ---------------------------------------------------------------------------

SERVE = ["--mode", "graph-diameter", "--device", "cpu", "--batch", "2",
         "--graph-n", "500", "--queries", "2", "--tau", "5",
         "--update-trace", "2"]


@pytest.mark.parametrize("backend,mix", [("kernel", "mixed"),
                                         ("single", "delete")])
def test_serve_replays_an_update_trace(capsys, backend, mix):
    assert serve.main(SERVE + ["--backend", backend, "--update-mix", mix,
                               "--bracket-rounds", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["estimator"] == "dynamic" and not out["failures"]
    assert out["transfers"] == out["counted_host_syncs"] > 0
    assert out["warm_backend_builds"] == out["warm_edge_uploads"] == 0
    assert out["update_batches"] == 4 and len(out["updates"]) == 4
    # one batch between the two rounds, the second drained after them
    assert [(u["graph"], u["batch"]) for u in out["updates"]] == \
        [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert all(u["action"] in ("relax", "repair", "rebuild")
               for u in out["updates"])
    assert [len(e) for e in out["update_directed_events"]] == [2, 2]
    for b in out["final_brackets"]:
        assert 0 < b["lower"] <= b["upper"]
    dm = out["dynamic_metrics"]
    assert out["baseline_supersteps"] == max(d["baseline_supersteps"]
                                             for d in dm)
    assert out["amortized_update_supersteps"] == sum(
        d["update_supersteps"] + d["rebuild_supersteps"] for d in dm) / 4
    assert (out["updates"][0]["rebind_seconds"] is None) == (backend
                                                             == "single")


def test_serve_update_cost_contract_fails(capsys):
    assert serve.main(SERVE + ["--check-update-cost", "1e9",
                               "--bracket-rounds", "0"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert any("amortized update cost" in f for f in out["failures"])
    assert all(b["lower"] == 0 for b in out["final_brackets"])


def test_chip_smoke_trace_jobs_match_update_traces():
    """The smoke run makes each CAL graph's trace in a worker process; seeded
    by the graph's index, it is ``update_traces``' trace of the pool."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    argv = ["--mode", "graph-diameter", "--update-trace", "2",
            "--update-events", "30"]
    pool = serve.update_traces([gen.road_like(900, seed=s) for s in (0, 1)],
                               serve.parse_args(argv))
    for s in (0, 1):
        trace, seconds = smoke.trace_job(900, s, argv)
        assert seconds >= 0.0 and len(trace) == 2
        for a, b in zip(pool[s], trace):
            for f in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(b, f.name),
                                              getattr(a, f.name))


def test_dynamic_path_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from repro_torch.core import UpdateBatch, open_session\n"
            "from repro_torch.graph import road_like, temporal_trace\n"
            "from repro_torch.launch import serve\n"
            "g = road_like(200)\n"
            "s = open_session(g, tau=4, device='cpu')\n"
            "for b in temporal_trace(g, 2, events_per_batch=6):\n"
            "    s.apply_updates(b)\n"
            "print('OK', s.estimate().method)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK dynamic-quotient" in r.stdout

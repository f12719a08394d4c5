"""The port's fused grow path (``KernelBackend(fuse=K)``) against the JAX
reference's unfused ``growth_loop`` + ``edge_relax_ref``, which the
reference's megakernel matches byte for byte by contract (its Pallas kernel
itself cannot run on JAX 0.9). On CPU tensors every fused call runs
``fused_grow_supersteps_plain``, the plain version the CUDA kernel is held
against on the card. Every plane is an integer: equality is exact."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import backend as ref_backend  # noqa: E402
from repro.core import state as ref_state  # noqa: E402
from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import state as st  # noqa: E402
from repro_torch.core.backend import KernelBackend  # noqa: E402
from repro_torch.core.cluster import cluster  # noqa: E402
from repro_torch.core.delta_growing import partial_growth  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.kernels.edge_relax import megakernel as mk  # noqa: E402
from repro_torch.kernels.edge_relax.kernel import megakernel_cuda  # noqa: E402


def jax_uniform_fn(seed: int):
    """The reference's stage draws, uniform(fold_in(fold_in(key, stage),
    t)), as float32 torch tensors."""
    key = jax.random.PRNGKey(seed)

    def draw(stage, t, n):
        k = jax.random.fold_in(jax.random.fold_in(key, stage), t)
        return torch.from_numpy(np.array(jax.random.uniform(k, (n,))))

    return draw


def _planes_np(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _mid_state(edges, delta, seed=0, frac=0.03):
    """A reference mid-decomposition state: stage 1 grown to quiescence
    with Δ/8 and covered (relays with negative offsets), stage 2 centers
    promoted and reset; every other node at the INF sentinel."""
    n = edges.n_nodes
    r = np.random.default_rng(seed)
    s = ref_state.init_state(n)
    s = ref_state.promote_centers(s, jnp.asarray(r.random(n) < frac))
    s = ref_state.reset_in_stage(s)
    be = ref_backend.SingleDeviceBackend(edges)
    s, _ = be.grow(s, delta // 8, n, 10 * n, "complete")
    s = ref_state.cover(s, jnp.int32(delta // 8))
    s = ref_state.promote_centers(s, jnp.asarray(r.random(n) < frac))
    return ref_state.reset_in_stage(s)


def _road():
    e = ref_gen.road_like(2000, seed=0)
    return e, int(np.median(e.weight)) * 24


def _big_weights():
    """Random graph with weights up to 2^30 - 1 and Δ = 2^30."""
    r = np.random.default_rng(7)
    n, m = 300, 1800
    src = r.integers(0, n, m).astype(np.int32)
    dst = r.integers(0, n, m).astype(np.int32)
    w = r.integers(1, 2**30, m).astype(np.int32)
    return RefEdgeList(n, np.concatenate([src, dst]),
                       np.concatenate([dst, src]),
                       np.concatenate([w, w])), 2**30


GRAPHS = {"road2000": _road, "bigw300": _big_weights}


def _grow_both(ref_edges, s_ref, delta, half, num_it, variant, k):
    want, ws = ref_backend.SingleDeviceBackend(ref_edges).grow(
        s_ref, delta, half, num_it, variant)
    edges, s = from_reference(ref_edges, _planes_np(s_ref), device="cpu")
    got, gs = KernelBackend(edges, "cpu", fuse=k).grow(
        s, delta, half, num_it, variant)
    return want, ws, got, gs


def _assert_grow_equal(want, ws, got, gs, k):
    for name in ("d", "c", "pathw"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(), name)
    assert gs.steps == int(ws.steps)
    assert gs.reached == int(ws.reached)
    assert gs.changed_last == bool(ws.changed_last)
    assert gs.kernel_supersteps == gs.steps
    assert gs.kernel_launches == max(1, -(-gs.steps // k)) == gs.syncs


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("variant", ["stop", "complete"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fused_grow_matches_reference(graph, variant, k):
    ref_edges, delta = GRAPHS[graph]()
    s_ref = _mid_state(ref_edges, delta, seed=1)
    n = ref_edges.n_nodes
    half = int(ref_state.uncovered_count(s_ref)) * 9 // 10
    want, ws, got, gs = _grow_both(ref_edges, s_ref, delta, half, 4 * n,
                                   variant, k)
    assert gs.steps > 1
    _assert_grow_equal(want, ws, got, gs, k)


@pytest.mark.parametrize("k,stop_at", [(8, 5), (8, 8), (8, 16), (3, 6),
                                       (3, 7)])
def test_stop_mid_launch_and_on_boundary(k, stop_at):
    """The stop variant's target met after exactly ``stop_at`` supersteps:
    inside a launch (5 of 8, 7 of 3+3+1) or on its last slot (8, 16, 6)."""
    ref_edges, delta = _road()
    s_ref = _mid_state(ref_edges, delta, seed=2)
    n = ref_edges.n_nodes
    reached = [int(ref_backend.SingleDeviceBackend(ref_edges).grow(
        s_ref, delta, n, s, "complete")[1].reached)
        for s in (stop_at - 1, stop_at)]
    assert reached[0] < reached[1]   # the target is first met at stop_at
    want, ws, got, gs = _grow_both(ref_edges, s_ref, delta, reached[1],
                                   4 * n, "stop", k)
    assert gs.steps == stop_at
    _assert_grow_equal(want, ws, got, gs, k)


@pytest.mark.parametrize("k", [3, 8])
def test_num_it_cap(k):
    ref_edges, delta = _road()
    s_ref = _mid_state(ref_edges, delta, seed=3)
    want, ws, got, gs = _grow_both(ref_edges, s_ref, delta, 0, 10,
                                   "complete", k)
    assert gs.steps == 10 and gs.changed_last
    _assert_grow_equal(want, ws, got, gs, k)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("center", [False, True])
def test_single_node(k, center):
    ref_edges = RefEdgeList(1, np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
    s_ref = ref_state.init_state(1)
    if center:
        s_ref = ref_state.promote_centers(s_ref, jnp.asarray([True]))
    want, ws, got, gs = _grow_both(ref_edges, s_ref, 5, 0, 4, "complete", k)
    assert gs.steps == 1
    _assert_grow_equal(want, ws, got, gs, k)


def _fused_inputs(seed=4):
    ref_edges, delta = _road()
    s_ref = _mid_state(ref_edges, delta, seed=seed)
    edges, s = from_reference(ref_edges, _planes_np(s_ref), device="cpu")
    be = KernelBackend(edges, "cpu", fuse=8)
    rw0, rc, rp, frozen = st.relay_planes(s)
    front = torch.ones(edges.n_nodes, dtype=torch.uint8)
    return edges, s, be.graph, (rw0, rc, rp), frozen, front, delta


@pytest.mark.parametrize("variant", ["stop", "complete"])
def test_frontier_skip_is_sound(variant):
    """Skipping rows with no source on the frontier changes nothing: the
    same launch with the skip turned off gives the same planes, frontier
    and stats (the skipped-row count is counted either way)."""
    edges, s, g, relay, frozen, front, delta = _fused_inputs()
    half = int(st.uncovered_count(s)) // 2
    params = mk.MegaParams(delta, half, 4 * edges.n_nodes, 0,
                           int(variant == "stop"))
    for k in (1, 8):
        on = mk.fused_grow_supersteps_plain((s.d, s.c, s.pathw), relay,
                                            frozen, front, g, params, k)
        off = mk.fused_grow_supersteps_plain((s.d, s.c, s.pathw), relay,
                                             frozen, front, g, params, k,
                                             skip=False)
        for a, b in zip(on, off):
            assert torch.equal(a, b)
        assert on[4][k, mk.COL_DEAD] > 0


def test_stats_rows_follow_the_unfused_loop():
    """Row j of one launch: executed, the nodes that changed in superstep
    j, reached after it, the continue flag; the summary row totals them.
    The frontier out is the set of nodes the last superstep changed."""
    edges, s, g, relay, frozen, front, delta = _fused_inputs(seed=5)
    n, k = edges.n_nodes, 8
    params = mk.MegaParams(delta, 0, 4 * n, 0, 0)
    d, c, p, front_out, stats = mk.fused_grow_supersteps(
        (s.d, s.c, s.pathw), relay, frozen, front, g, params, k)
    src, dst, w = (torch.from_numpy(x) for x in (edges.src, edges.dst,
                                                 edges.weight))
    prev = s
    for j in range(k):
        cur, gs = partial_growth(s, src, dst, w, delta, 0, j + 1, n,
                                 variant="complete", chunk=1)
        changed = int((cur.d != prev.d).sum())
        assert stats[j].tolist() == [1, changed, gs.reached,
                                     int(stats[j, mk.COL_DEAD]), 1, 0, 0, 0]
        prev_front = (cur.d != prev.d)
        prev = cur
    assert torch.equal(d, cur.d) and torch.equal(c, cur.c)
    assert torch.equal(p, cur.pathw)
    assert torch.equal(front_out.bool(), prev_front)
    assert stats[k].tolist() == [k, 1, gs.reached,
                                 int(stats[k - 1, mk.COL_DEAD]), 1, 0, 0, 0]
    assert (stats[1:k, mk.COL_DEAD] >= stats[:k - 1, mk.COL_DEAD]).all()


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: CPU tensors are refused
    before anything is built (the dispatcher never sends them there)."""
    edges, s, g, relay, frozen, front, delta = _fused_inputs()
    with pytest.raises(ValueError, match="must be on"):
        megakernel_cuda((s.d, s.c, s.pathw), relay, frozen, front, g,
                        (delta, 0, 10, 0, 0), 8)


@pytest.mark.parametrize("graph", ["road", "rmat", "isolated"])
def test_out_csr_is_the_transpose(graph):
    """The kernel marks dirty rows through the out-edge CSR: it must hold
    exactly the in-edge CSR's edges, ordered by (src, dst), so the rows it
    marks are the rows the plain version finds from ``front[src]``."""
    e = {"road": lambda: gen.road_like(500, seed=1),
         "rmat": lambda: gen.social_like(9, seed=2),
         "isolated": lambda: EdgeList(5, np.array([3, 3], np.int32),
                                      np.array([1, 0], np.int32),
                                      np.array([2, 2], np.int32))}[graph]()
    g = KernelBackend(e, "cpu", fuse=8).graph
    out_ptr, out_dst = g.out_csr()
    assert out_ptr.dtype == out_dst.dtype == torch.int32
    deg = (out_ptr[1:] - out_ptr[:-1]).to(torch.int64)
    out_src = torch.repeat_interleave(torch.arange(e.n_nodes), deg)
    pairs_out = sorted(zip(out_src.tolist(), out_dst.tolist()))
    assert pairs_out == list(zip(out_src.tolist(), out_dst.tolist()))
    assert pairs_out == sorted(zip(g.src.tolist(), g.dst.tolist()))
    assert g.out_csr()[0] is out_ptr     # built once


def test_kernel_backend_fuse_limits():
    e = gen.road_like(50, seed=0)
    with pytest.raises(ValueError, match="fuse must be >= 0"):
        KernelBackend(e, "cpu", fuse=-1)
    huge = EdgeList(2**27, np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="int32 counts"):
        KernelBackend(huge, "cpu", fuse=16)
    assert KernelBackend(e, "cpu").fuse == 0


CLUSTER_GRAPHS = [
    ("road2000", lambda m: m.road_like(2000, seed=0), 4),
    ("social10", lambda m: m.social_like(10, seed=0), 4),
]


@pytest.mark.parametrize("graph", CLUSTER_GRAPHS, ids=lambda g: g[0])
def test_stages_decomposition_fused_equals_unfused_and_reference(graph):
    _, make, tau = graph
    ref_edges, edges = make(ref_gen), make(gen)
    want = ref_cluster(ref_edges, tau, seed=3)
    got = {}
    for fuse in (0, 8):
        got[fuse] = cluster(edges, tau, seed=3, device="cpu",
                            backend=KernelBackend(edges, "cpu", fuse=fuse),
                            uniform_fn=jax_uniform_fn(3))
    for dec in got.values():
        np.testing.assert_array_equal(want.final_c, dec.final_c)
        np.testing.assert_array_equal(want.final_pathw, dec.final_pathw)
        for f in ("radius", "n_stages", "growing_steps", "delta_end",
                  "n_clusters"):
            assert getattr(want, f) == getattr(dec, f), f
        assert dec.metrics.grow_calls == want.metrics.grow_calls
        assert dec.metrics.kernel_launches == 0    # no CUDA launch on CPU
    fused = got[8].metrics
    assert fused.kernel_supersteps == got[8].growing_steps
    assert fused.dma_stall_blocks > 0
    assert got[0].metrics.kernel_supersteps == 0

"""The port's engine against the JAX package: state helpers, PartialGrowth
(stop and complete), the chunked superstep loop against an unchunked one,
and whole CLUSTER decompositions with the reference's ``jax.random``
center draws injected. Every plane is an integer: equality is exact."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.core import delta_growing as ref_dg  # noqa: E402
from repro.core import state as ref_state  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import state as st  # noqa: E402
from repro_torch.core.backend import make_backend  # noqa: E402
from repro_torch.core.cluster import cluster  # noqa: E402
from repro_torch.core.delta_growing import growth_loop, partial_growth  # noqa: E402
from repro_torch.core.engine import default_uniform_fn  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.segment_ops import segment_min_triple  # noqa: E402
from repro_torch.kernels.edge_relax.ref import edge_relax_candidates  # noqa: E402


def jax_uniform_fn(seed: int):
    """The reference's center draw: uniform(fold_in(fold_in(key, stage), t))
    (``engine.py:304-327``, ``:556``), as float32 torch tensors."""
    key = jax.random.PRNGKey(seed)

    def draw(stage, t, n):
        k = jax.random.fold_in(jax.random.fold_in(key, stage), t)
        return torch.from_numpy(np.array(jax.random.uniform(k, (n,))))

    return draw


def _planes_np(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _assert_state_equal(ref_s, port_s):
    for name, a in _planes_np(ref_s).items():
        b = getattr(port_s, name).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)


def _mid_state(edges, seed=0):
    """A reference mid-decomposition state: stage 1 grown and covered
    (relays with negative offsets), stage 2 centers promoted and reset."""
    n = edges.n_nodes
    r = np.random.default_rng(seed)
    src, dst, w = (jnp.asarray(edges.src), jnp.asarray(edges.dst),
                   jnp.asarray(edges.weight))
    s = ref_state.init_state(n)
    s = ref_state.promote_centers(s, jnp.asarray(r.random(n) < 0.03))
    s = ref_state.reset_in_stage(s)
    delta = int(np.median(edges.weight)) * 3
    s, _ = ref_dg.partial_growth(s, src, dst, w, jnp.int32(delta),
                                 jnp.int32(n), jnp.int32(10 * n), n,
                                 variant="complete")
    s = ref_state.cover(s, jnp.int32(delta))
    s = ref_state.promote_centers(s, jnp.asarray(r.random(n) < 0.03))
    s = ref_state.reset_in_stage(s)
    return s, delta


@pytest.fixture(scope="module")
def road():
    return ref_gen.road_like(2000, seed=0)


def test_state_helpers_match(road):
    s_ref, delta = _mid_state(road)
    _, s = from_reference(road, _planes_np(s_ref), device="cpu")
    _assert_state_equal(s_ref, s)
    for a, b in zip(ref_state.relay_planes(s_ref), st.relay_planes(s)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_state_equal(ref_state.cover(s_ref, jnp.int32(delta)),
                        st.cover(s, delta))
    _assert_state_equal(ref_state.finalize_singletons(s_ref),
                        st.finalize_singletons(s))
    _assert_state_equal(ref_state.pad_state(s_ref, road.n_nodes + 37),
                        st.pad_state(s, road.n_nodes + 37))
    assert int(ref_state.uncovered_count(s_ref)) == int(st.uncovered_count(s))
    _assert_state_equal(ref_state.init_state(50), st.init_state(50, "cpu"))


@pytest.mark.parametrize("variant", ["stop", "complete"])
@pytest.mark.parametrize("backend", ["single", "kernel"])
def test_partial_growth_matches_reference(road, variant, backend):
    s_ref, delta = _mid_state(road, seed=1)
    n = road.n_nodes
    half = int(ref_state.uncovered_count(s_ref)) // 2
    num_it = 2 * n // 4
    want, ws = ref_dg.partial_growth(
        s_ref, jnp.asarray(road.src), jnp.asarray(road.dst),
        jnp.asarray(road.weight), jnp.int32(delta), jnp.int32(half),
        jnp.int32(num_it), n, variant=variant)
    edges, s = from_reference(road, _planes_np(s_ref), device="cpu")
    if backend == "single":
        got, gs = partial_growth(
            s, torch.from_numpy(edges.src), torch.from_numpy(edges.dst),
            torch.from_numpy(edges.weight), delta, half, num_it, n,
            variant=variant)
    else:
        be = make_backend(edges, "kernel", device="cpu")
        got, gs = be.grow(s, delta, half, num_it, variant)
    _assert_state_equal(want, got)
    assert gs.steps == int(ws.steps) and gs.steps > 1
    assert gs.reached == int(ws.reached)
    assert gs.changed_last == bool(ws.changed_last)


def _unchunked_growth(s, edges, delta, half, num_it, variant):
    """The loop as plainly written: one host read per superstep."""
    rw0, rc, rp, frozen = st.relay_planes(s)
    src = torch.from_numpy(edges.src).long()
    dst = torch.from_numpy(edges.dst)
    w = torch.from_numpy(edges.weight)
    k, changed = 0, True
    while changed and k < num_it and (
            variant != "stop"
            or int(((~frozen) & (s.d < delta)).sum()) < half):
        cd, cc, cp = edge_relax_candidates(s.d[src], s.c[src], s.pathw[src],
                                           rw0[src], rc[src], rp[src], w,
                                           True, delta)
        dm, cm, pm = segment_min_triple(cd, cc, cp, dst, edges.n_nodes)
        upd = (~frozen) & (dm < s.d)
        s = s.replace(d=torch.where(upd, dm, s.d), c=torch.where(upd, cm, s.c),
                      pathw=torch.where(upd, pm, s.pathw))
        changed = bool(upd.any())
        k += 1
    return s, k


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("variant", ["stop", "complete"])
def test_chunked_loop_equals_unchunked(road, chunk, variant):
    s_ref, delta = _mid_state(road, seed=2)
    edges, s = from_reference(road, _planes_np(s_ref), device="cpu")
    n = edges.n_nodes
    half = int(st.uncovered_count(s)) // 2
    want, k = _unchunked_growth(s, edges, delta, half, 4 * n, variant)
    got, gs = partial_growth(
        s, torch.from_numpy(edges.src), torch.from_numpy(edges.dst),
        torch.from_numpy(edges.weight), delta, half, 4 * n, n,
        variant=variant, chunk=chunk)
    assert gs.steps == k
    assert gs.syncs == max(1, -(-k // chunk))   # one read per chunk
    for name in ("d", "c", "pathw"):
        assert torch.equal(getattr(want, name), getattr(got, name)), name


def test_growth_loop_step_cap_and_idle_supersteps():
    """num_it caps the loop; supersteps issued after the stop are no-ops."""
    calls = []
    s = st.init_state(4, "cpu")
    s = st.promote_centers(s, torch.tensor([True, False, False, False]))
    s = st.reset_in_stage(s)
    frozen = s.is_center.clone()

    def relax(x):
        calls.append(1)
        # every superstep offers node 1..3 a strictly better distance
        d = torch.where(frozen, x.d, torch.clamp_min(x.d, 10) - 1)
        return d, torch.zeros_like(d), torch.zeros_like(d)

    out, gs = growth_loop(s, relax, frozen, 2**30, 0, 5, "complete", chunk=4)
    assert gs.steps == 5 and gs.changed_last and len(calls) == 8
    assert out.d[1:].tolist() == [2**31 - 1 - 5] * 3


CLUSTER_GRAPHS = [
    ("road2000", lambda m: m.road_like(2000, seed=0), 4),
    ("road2000-tau8", lambda m: m.road_like(2000, seed=0), 8),
    ("social10", lambda m: m.social_like(10, seed=0), 4),
]


@pytest.mark.parametrize("backend", ["single", "kernel"])
@pytest.mark.parametrize("graph", CLUSTER_GRAPHS, ids=lambda g: g[0])
def test_run_cluster_matches_reference(graph, backend):
    _, make, tau = graph
    ref_edges, edges = make(ref_gen), make(gen)
    want = ref_cluster(ref_edges, tau, seed=3)
    got = cluster(edges, tau, seed=3, backend=backend, device="cpu",
                  uniform_fn=jax_uniform_fn(3))
    np.testing.assert_array_equal(want.final_c, got.final_c)
    np.testing.assert_array_equal(want.final_pathw, got.final_pathw)
    for f in ("radius", "n_stages", "growing_steps", "delta_end",
              "n_clusters"):
        assert getattr(want, f) == getattr(got, f), f
    assert got.metrics.grow_calls == want.metrics.grow_calls
    assert got.metrics.resamples == want.metrics.resamples
    assert got.metrics.kernel_launches == 0      # plain path on the CPU
    assert got.metrics.state_transfers == 1


def test_default_draw_is_deterministic_and_decomposes():
    edges = gen.road_like(1200, seed=1)
    a = cluster(edges, 4, seed=5, device="cpu")
    b = cluster(edges, 4, seed=5, device="cpu", backend="single")
    np.testing.assert_array_equal(a.final_c, b.final_c)
    np.testing.assert_array_equal(a.final_pathw, b.final_pathw)
    u = default_uniform_fn(5, "cpu")
    assert torch.equal(u(2, 1, 100), u(2, 1, 100))
    assert not torch.equal(u(2, 1, 100), u(2, 0, 100))
    # every node is assigned to a center that assigns itself
    fc = a.final_c
    assert (fc[fc] == fc).all() and a.radius == int(a.final_pathw.max())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cluster(gen.road_like(50), 4)

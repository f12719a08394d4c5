"""The port's one-shot decomposition mode against the JAX reference's
(``run_oneshot``): the start shifts of the drawn centers, then whole
decompositions byte for byte, with the deterministic hashed draw and with
the reference's ``jax.random`` uniforms injected; the engine-mode names;
the fused grow path in one-shot mode; and a certified bracket."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.sparse.csgraph import shortest_path  # noqa: E402

from repro.core import backend as ref_backend  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import state as ref_state  # noqa: E402
from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro_torch.common import GraphEngineConfig  # noqa: E402
from repro_torch.core import (DECOMPOSITION_MODES, ENGINE_MODES,  # noqa: E402
                              ClusterQuotientEstimator, IntervalEstimator,
                              open_session, resolve_engine_mode)
from repro_torch.core.backend import KernelBackend, make_backend  # noqa: E402
from repro_torch.core.cluster import cluster  # noqa: E402
from repro_torch.core.engine import (hashed_uniforms,  # noqa: E402
                                     oneshot_budget, oneshot_centers,
                                     run_oneshot)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph import to_scipy_csr  # noqa: E402
from repro_torch.launch import diameter as launcher  # noqa: E402

SEED = 3
TAU = 4


def jax_oneshot_uniform_fn(seed: int):
    """The reference's one-shot draw, ``k1, k2 = split(PRNGKey(seed))``
    and ``uniform(k1)``, ``uniform(k2)`` (``engine.py:721-723``), in the
    port's hook: ``draw(0, 0, n)`` is u1 and ``draw(0, 1, n)`` is u2."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))

    def draw(stage, t, n):
        assert stage == 0 and t in (0, 1)
        return torch.from_numpy(np.array(
            jax.random.uniform(k1 if t == 0 else k2, (n,))))

    return draw


def _ref_oneshot_state(ref_edges, tau, seed, deterministic, p=None):
    """The reference's one-shot device program (``_oneshot_stage``), run
    with the port's budget scalars. Its drawn centers keep ``d =
    start_d`` (frozen), so the returned state exposes their shifts."""
    b = oneshot_budget(ref_edges, tau)
    be = ref_backend.SingleDeviceBackend(ref_edges)
    state, _ = ref_engine._oneshot_stage(
        ref_state.init_state(ref_edges.n_nodes), jax.random.PRNGKey(seed),
        jnp.float32(b.p if p is None else p), jnp.int32(b.shift_max),
        jnp.float32(b.shift_scale), jnp.int32(b.max_delta),
        jnp.int32(b.num_it), be.graph_args(), spec=be.grow_spec(),
        n=ref_edges.n_nodes, deterministic=deterministic)
    return np.asarray(state.is_center), np.asarray(state.d)


def _port_uniforms(n, deterministic):
    if deterministic:
        return hashed_uniforms(n, "cpu")
    draw = jax_oneshot_uniform_fn(SEED)
    return draw(0, 0, n), torch.clamp_min(draw(0, 1, n), 2.0 ** -32)


def _graphs(n):
    return ref_gen.road_like(n, seed=0), gen.road_like(n, seed=0)


@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["hashed", "jax-random"])
@pytest.mark.parametrize("n", [2000, 5000])
def test_oneshot_matches_reference(n, deterministic):
    ref_edges, edges = _graphs(n)
    # the drawn centers and their shifts first (a float32 log that differs
    # in the last ulp could move a shift by one; none does at these sizes)
    is_c, d_ref = _ref_oneshot_state(ref_edges, TAU, SEED, deterministic)
    b = oneshot_budget(edges, TAU)
    mask, start = oneshot_centers(*_port_uniforms(n, deterministic), b.p,
                                  b.shift_max, b.shift_scale)
    np.testing.assert_array_equal(mask.numpy(), is_c)
    np.testing.assert_array_equal(start.numpy()[is_c], d_ref[is_c])
    # then the whole decomposition
    want = ref_cluster(ref_edges, TAU, seed=SEED, mode="oneshot",
                       deterministic=deterministic)
    got = cluster(edges, TAU, seed=SEED, device="cpu", mode="oneshot",
                  deterministic=deterministic,
                  uniform_fn=jax_oneshot_uniform_fn(SEED))
    np.testing.assert_array_equal(want.final_c, got.final_c)
    np.testing.assert_array_equal(want.final_pathw, got.final_pathw)
    for f in ("radius", "n_stages", "growing_steps", "delta_end",
              "n_clusters"):
        assert getattr(want, f) == getattr(got, f), f
    assert got.n_stages == 1 and got.growing_steps > 1


def test_oneshot_with_reference_start_planes():
    """The general mechanism: the reference's start plane injected, so no
    float32 ``log`` of the port's enters the comparison."""
    ref_edges, edges = _graphs(2000)
    is_c, d_ref = _ref_oneshot_state(ref_edges, TAU, SEED, False)
    want = ref_cluster(ref_edges, TAU, seed=SEED, mode="oneshot")
    got = run_oneshot(edges, make_backend(edges, "single", device="cpu"),
                      TAU, seed=SEED, uniform_fn=jax_oneshot_uniform_fn(SEED),
                      start_d=torch.from_numpy(np.where(is_c, d_ref, 0)))
    np.testing.assert_array_equal(want.final_c, got.final_c)
    np.testing.assert_array_equal(want.final_pathw, got.final_pathw)
    assert want.growing_steps == got.growing_steps


def test_float32_log_differs_by_at_most_one_ulp():
    """XLA's and torch's float32 ``log`` are both within an ulp of the true
    value, so they may differ in the last ulp (measured on the CPU: on 294
    of 2,000 hashed ``u2`` values, and 267,798 of 1,890,815). The one-shot
    shift ``int(-log(u2) * shift_scale)`` can then move by one. Bound both
    on every node of a 200,000-node hashed draw, with the reference's
    formula (``engine.py:728-730``) evaluated by XLA."""
    n = 200_000
    _, u2 = hashed_uniforms(n, "cpu")
    lx = np.asarray(jnp.log(jnp.asarray(u2.numpy())))
    lt = torch.log(u2).numpy()
    ulps = np.abs(lx.view(np.int32).astype(np.int64)
                  - lt.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    b = oneshot_budget(gen.road_like(n, seed=0), 130)
    shift = jnp.minimum(-jnp.log(jnp.asarray(u2.numpy()))
                        * jnp.float32(b.shift_scale),
                        jnp.float32(b.shift_max))
    shift_ref = np.asarray(jnp.clip(shift.astype(jnp.int32), 0, b.shift_max))
    _, start = oneshot_centers(torch.zeros(n), u2, 1.0, b.shift_max,
                               b.shift_scale)
    shift_port = b.shift_max - start.numpy().astype(np.int64)
    assert np.abs(shift_port - shift_ref).max() <= 1


def test_empty_draw_takes_the_argmin_center():
    ref_edges, edges = _graphs(2000)
    b = oneshot_budget(edges, TAU)
    for deterministic in (True, False):
        u1, u2 = _port_uniforms(2000, deterministic)
        mask, _ = oneshot_centers(u1, u2, 0.0, b.shift_max, b.shift_scale)
        assert mask.sum() == 1 and bool(mask[torch.argmin(u1)])
        is_c, _ = _ref_oneshot_state(ref_edges, TAU, SEED, deterministic,
                                     p=0.0)
        np.testing.assert_array_equal(mask.numpy(), is_c)


def test_engine_mode_names():
    assert ENGINE_MODES == ref_engine.ENGINE_MODES
    assert set(DECOMPOSITION_MODES) == set(ref_engine.DECOMPOSITION_MODES)
    with pytest.raises(ValueError) as want:
        ref_engine.check_engine_mode("bogus")
    edges = gen.road_like(300, seed=0)
    calls = [
        lambda: cluster(edges, TAU, device="cpu", mode="bogus"),
        lambda: open_session(edges, GraphEngineConfig(mode="bogus"),
                             device="cpu"),
        lambda: ClusterQuotientEstimator(mode="bogus").estimate(
            open_session(edges, device="cpu")),
        lambda: launcher.main(["--n", "300", "--device", "cpu",
                               "--engine-mode", "bogus"]),
    ]
    for call in calls:
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)
    assert resolve_engine_mode("auto") == "stages"
    session = open_session(edges, GraphEngineConfig(mode="auto"),
                           device="cpu", tau=TAU)
    assert session.cfg.mode == "stages"
    auto = cluster(edges, TAU, device="cpu", mode="auto")
    stages = cluster(edges, TAU, device="cpu")
    np.testing.assert_array_equal(auto.final_c, stages.final_c)


@pytest.mark.parametrize("deterministic", [True, False])
def test_oneshot_fused_equals_unfused(deterministic):
    edges = gen.road_like(5000, seed=0)
    decs = [run_oneshot(edges, KernelBackend(edges, "cpu", fuse=fuse), TAU,
                        seed=SEED, deterministic=deterministic)
            for fuse in (0, 8)]
    np.testing.assert_array_equal(decs[0].final_c, decs[1].final_c)
    np.testing.assert_array_equal(decs[0].final_pathw, decs[1].final_pathw)
    assert decs[0].growing_steps == decs[1].growing_steps
    m = decs[1].metrics
    assert m.kernel_supersteps == decs[1].growing_steps
    assert m.host_syncs == -(-decs[1].growing_steps // 8)
    assert decs[0].metrics.kernel_supersteps == 0


@pytest.mark.parametrize("fuse", [0, 8])
def test_oneshot_session_interval_brackets_exact(fuse):
    """A session opened in one-shot mode runs it in the interval's
    cluster-quotient estimator; scipy's exact diameter lies inside."""
    edges = gen.road_like(2000, seed=0)
    cfg = GraphEngineConfig(mode="oneshot", deterministic=True,
                            fuse_supersteps=fuse)
    session = open_session(edges, cfg, device="cpu")
    iv = IntervalEstimator().estimate(session)
    exact = int(shortest_path(to_scipy_csr(edges), method="D",
                              directed=False).max())
    assert iv.connected and iv.lower <= exact <= iv.upper
    est = iv.estimates["cluster-quotient"]
    assert est.n_stages == 1 and est.delta_end == oneshot_budget(
        edges, session.tau).max_delta
    assert est.pipeline.kernel_supersteps == (est.growing_steps if fuse
                                              else 0)

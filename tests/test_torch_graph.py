"""Parity of the port's host graph layer with the JAX package: generator
arrays must be identical for the same seed, and the segment tuple-min
(int32 and int64) must equal the jnp version exactly."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax
import jax.experimental

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph import segment_ops as ref_seg  # noqa: E402
from repro.graph import structures as ref_struct  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph import segment_ops as seg  # noqa: E402
from repro_torch.graph import structures as struct  # noqa: E402


def _same_edges(a, b):
    assert a.n_nodes == b.n_nodes
    for name in ("src", "dst", "weight"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("make", [
    lambda m: m.road_like(1500, seed=0),
    lambda m: m.road_like(777, seed=3),
    lambda m: m.random_geometric(600, avg_degree=5.0, seed=2,
                                 weight_scale=300),
    lambda m: m.social_like(9, seed=1),
    lambda m: m.rmat(8, 900, seed=4, weight_dist="bimodal"),
    lambda m: m.grid_mesh(7, weight_dist="normal", seed=5),
    lambda m: m.grid_mesh(5),
], ids=["road1500", "road777", "geometric", "social", "rmat-bimodal",
        "mesh-normal", "mesh-unit"])
def test_generators_identical(make):
    _same_edges(make(ref_gen), make(gen))


@pytest.mark.parametrize("dist", ["uniform", "normal", "bimodal", "unit"])
def test_assign_weights_identical(dist):
    np.testing.assert_array_equal(ref_gen.assign_weights(500, dist, seed=9),
                                  gen.assign_weights(500, dist, seed=9))


def test_edge_list_helpers_match():
    r = np.random.default_rng(0)
    n = 50
    src = r.integers(0, n, 400).astype(np.int32)
    dst = r.integers(0, n, 400).astype(np.int32)
    w = r.integers(1, 20, 400).astype(np.int32)
    a = ref_struct.EdgeList(n, src, dst, w)
    b = struct.EdgeList(n, src, dst, w)
    _same_edges(a.coalesce(), b.coalesce())
    _same_edges(a.sorted_by_dst(), b.sorted_by_dst())
    _same_edges(a.remove_self_loops(), b.remove_self_loops())
    for x, y in zip(a.degrees(), b.degrees()):
        np.testing.assert_array_equal(x, y)
    ws = np.array([1, 2**30 - 1, 2**33, 5 * 2**32 + 7], np.int64)
    (rw, rs), (pw, ps) = (ref_struct.rescale_weights(ws),
                          struct.rescale_weights(ws))
    assert rs == ps == ref_struct.weight_scale_for(int(ws.max()))
    np.testing.assert_array_equal(rw, pw)
    assert (ref_struct.to_scipy_csr(a) != struct.to_scipy_csr(b)).nnz == 0
    with pytest.raises(ValueError):
        struct.EdgeList(2, [0], [1], [2**30])


def _segment_case(dtype, seed):
    r = np.random.default_rng(seed)
    e, n = 3000, 200
    hi = 40 if dtype == np.int32 else 2**40
    d = r.integers(0, hi, e).astype(dtype)
    c = r.integers(0, 6, e).astype(np.int32)     # many ties on (d, c)
    p = r.integers(0, hi, e).astype(dtype)
    sid = r.integers(0, n - 7, e).astype(np.int32)  # last segments empty
    return d, c, p, sid, n


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_segment_min_triple_matches_jnp(dtype):
    d, c, p, sid, n = _segment_case(dtype, seed=int(np.dtype(dtype).itemsize))
    with jax.experimental.enable_x64():
        ref = ref_seg.segment_min_triple(jnp.asarray(d), jnp.asarray(c),
                                         jnp.asarray(p), jnp.asarray(sid),
                                         num_segments=n)
        ref = [np.asarray(x) for x in ref]
    out = seg.segment_min_triple(torch.from_numpy(d), torch.from_numpy(c),
                                 torch.from_numpy(p), torch.from_numpy(sid), n)
    for name, a, b in zip("dcp", ref, out):
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_segment_min_pair_matches_jnp(dtype):
    d, c, _, sid, n = _segment_case(dtype, seed=11)
    with jax.experimental.enable_x64():
        ref = ref_seg.segment_min_pair(jnp.asarray(d), jnp.asarray(c),
                                       jnp.asarray(sid), num_segments=n)
        ref = [np.asarray(x) for x in ref]
    out = seg.segment_min_pair(torch.from_numpy(d), torch.from_numpy(c),
                               torch.from_numpy(sid), n)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b.numpy())


def test_segment_min_2d_matches_jnp():
    r = np.random.default_rng(3)
    vals = r.integers(0, 1000, (500, 7)).astype(np.int64)
    sid = r.integers(0, 40, 500).astype(np.int32)
    with jax.experimental.enable_x64():
        ref = np.asarray(jax.ops.segment_min(jnp.asarray(vals),
                                             jnp.asarray(sid),
                                             num_segments=45))
    out = seg.segment_min(torch.from_numpy(vals), torch.from_numpy(sid), 45)
    np.testing.assert_array_equal(ref, out.numpy())

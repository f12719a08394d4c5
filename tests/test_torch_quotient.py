"""The port's quotient pass, quotient solve and Bellman-Ford loops against
the JAX package and scipy. Edge arrays, counters and distances are
integers: equality is exact."""
import contextlib

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

from repro.core import quotient as ref_q  # noqa: E402
from repro.core import sssp as ref_sssp  # noqa: E402
from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.core import quotient as q  # noqa: E402
from repro_torch.core import sssp  # noqa: E402
from repro_torch.core.engine import Decomposition  # noqa: E402
from repro_torch.graph.structures import EdgeList, to_scipy_csr  # noqa: E402

INF64 = 2**62


def _decomposition(n, final_c, final_pathw):
    final_c, final_pathw = np.array(final_c), np.array(final_pathw)
    return Decomposition(n_nodes=n, final_c=final_c, final_pathw=final_pathw,
                         radius=int(final_pathw.max()), delta_end=1,
                         n_clusters=len(np.unique(final_c)), n_stages=1,
                         growing_steps=0)


def _random_decomposition(n, n_centers, seed, pathw_hi=1000):
    r = np.random.default_rng(seed)
    centers = r.choice(n, n_centers, replace=False)
    fc = centers[r.integers(0, n_centers, n)].astype(np.int32)
    fc[centers] = centers
    fp = r.integers(0, pathw_hi, n).astype(np.int32)
    fp[centers] = 0
    return _decomposition(n, fc, fp)


def _ref_device_quotient(src, dst, w, mask, dec, n):
    with jax.experimental.enable_x64():
        dq = ref_q._quotient_kernel(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
            jnp.asarray(mask), jnp.asarray(dec.final_c),
            jnp.asarray(dec.final_pathw), n=n)
        return {k: np.asarray(v) for k, v in dq._asdict().items()}


def _port_device_quotient(src, dst, w, dec, n):
    dq = q._quotient_kernel(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        torch.from_numpy(dec.final_c), torch.from_numpy(dec.final_pathw),
        n=n)
    return {k: getattr(dq, k).numpy() for k in
            ("centers", "src", "dst", "weight", "n_clusters", "n_edges",
             "max_weight", "weight_sum")}


def _assert_quotients_equal(ref, port):
    for k, a in ref.items():
        np.testing.assert_array_equal(a, port[k], err_msg=k)


def _road_case():
    e = ref_gen.road_like(1500, seed=2)
    dec = ref_cluster(e, 6, seed=1)
    return e, _decomposition(e.n_nodes, dec.final_c, dec.final_pathw)


@pytest.mark.parametrize("case", ["road", "random", "csr-order", "heavy"])
def test_quotient_kernel_matches_reference_and_numpy(case):
    if case == "road":
        e, dec = _road_case()
    else:
        r = np.random.default_rng(7)
        n, m = 400, 2500
        wmax = 2**30 - 1 if case == "heavy" else 50
        e = RefEdgeList.from_undirected(
            n, r.integers(0, n, m).astype(np.int32),
            r.integers(0, n, m).astype(np.int32),
            r.integers(1, wmax + 1, m).astype(np.int32))
        dec = _random_decomposition(n, 37, seed=3,
                                    pathw_hi=2**30 if case == "heavy" else 900)
    n = e.n_nodes
    src, dst, w = e.src, e.dst, e.weight
    if case == "csr-order":
        # the kernel backend hands over its CSR: the same edges in (dst, src)
        # order
        order = np.lexsort((src, dst))
        src, dst, w = src[order], dst[order], w[order]
    ref = _ref_device_quotient(src, dst, w, np.ones(len(src), bool), dec, n)
    port = _port_device_quotient(src, dst, w, dec, n)
    _assert_quotients_equal(ref, port)
    # and the host numpy oracle, edge for edge over the valid prefix
    host = q.build_quotient_numpy(
        EdgeList(n, e.src, e.dst, e.weight), dec)
    m, k = int(port["n_edges"]), int(port["n_clusters"])
    assert (m, k) == (len(host.src), host.n_clusters)
    np.testing.assert_array_equal(port["centers"][:k], host.center_ids)
    np.testing.assert_array_equal(port["src"][:m], host.src)
    np.testing.assert_array_equal(port["dst"][:m], host.dst)
    np.testing.assert_array_equal(port["weight"][:m], host.weight)
    ref_host = ref_q.build_quotient_numpy(e, dec)
    np.testing.assert_array_equal(ref_host.weight, host.weight)


class _Backend:
    def __init__(self, src, dst, w):
        self.args = (torch.from_numpy(src), torch.from_numpy(dst),
                     torch.from_numpy(w))

    def flat_edges(self):
        return self.args


def _port_dq_from_host(qg):
    """Symmetrized host quotient -> the port's DeviceQuotient (mirrors the
    reference's ``quotient_diameter_device``)."""
    src = np.concatenate([qg.src, qg.dst]).astype(np.int32)
    dst = np.concatenate([qg.dst, qg.src]).astype(np.int32)
    w = np.concatenate([qg.weight, qg.weight]).astype(np.int64)
    t = torch.tensor
    dq = q.DeviceQuotient(
        centers=torch.from_numpy(qg.center_ids.astype(np.int32)),
        src=torch.from_numpy(src), dst=torch.from_numpy(dst),
        weight=torch.from_numpy(w), n_clusters=t(qg.n_clusters),
        n_edges=t(len(src)), max_weight=t(int(w.max()) if len(w) else 0),
        weight_sum=t(int(w.sum())))
    return dq, len(src), int(w.max()) if len(w) else 0


def _ref_solve(qg):
    src = np.concatenate([qg.src, qg.dst]).astype(np.int32)
    dst = np.concatenate([qg.dst, qg.src]).astype(np.int32)
    w = np.concatenate([qg.weight, qg.weight]).astype(np.int64)
    with jax.experimental.enable_x64():
        dq = ref_q.DeviceQuotient(
            centers=jnp.asarray(qg.center_ids.astype(np.int32)),
            src=jnp.asarray(src), dst=jnp.asarray(dst), weight=jnp.asarray(w),
            n_clusters=jnp.int32(qg.n_clusters), n_edges=jnp.int32(len(src)),
            max_weight=jnp.int64(int(w.max())),
            weight_sum=jnp.int64(int(w.sum())))
    return ref_q.solve_device_quotient(dq, qg.n_clusters, len(src),
                                       int(w.max()))


def _path_quotient(k, w):
    u = np.arange(k - 1, dtype=np.int32)
    return q.QuotientGraph(n_clusters=k, center_ids=np.arange(k, dtype=np.int32),
                           src=u, dst=u + 1, weight=np.full(k - 1, w, np.int64))


@pytest.mark.parametrize("qcase", ["int32-path", "int64-path-2^30-1",
                                   "int64-2^40", "road", "disconnected"])
def test_solve_matches_reference_and_scipy(qcase):
    if qcase == "int32-path":
        qg = _path_quotient(9, 1000)
    elif qcase == "int64-path-2^30-1":
        qg = _path_quotient(6, 2**30 - 1)     # 5 hops overflow int32
    elif qcase == "int64-2^40":
        r = np.random.default_rng(4)
        base = _path_quotient(20, 1)
        extra_u = r.integers(0, 20, 30).astype(np.int32)
        extra_v = r.integers(0, 20, 30).astype(np.int32)
        keep = extra_u != extra_v
        qg = q.QuotientGraph(
            20, base.center_ids, np.concatenate([base.src, extra_u[keep]]),
            np.concatenate([base.dst, extra_v[keep]]),
            r.integers(1, 2**40, 19 + keep.sum()).astype(np.int64))
    elif qcase == "road":
        e, dec = _road_case()
        qg = q.build_quotient_numpy(EdgeList(e.n_nodes, e.src, e.dst, e.weight),
                                    dec)
    else:
        qg = _path_quotient(7, 5)
        qg = q.QuotientGraph(7, qg.center_ids, qg.src[[0, 1, 3, 4]],
                             qg.dst[[0, 1, 3, 4]], qg.weight[[0, 1, 3, 4]])
    dq, m, wmax = _port_dq_from_host(qg)
    sol = q.solve_device_quotient(dq, qg.n_clusters, m, wmax, chunk=3)
    diam, ecc, connected, steps, reads = (sol.diameter, sol.ecc, sol.connected,
                                          sol.supersteps, sol.reads)
    if qcase != "road":
        small = qcase in ("int32-path", "disconnected")
        assert sol.dtype == ("int32" if small else "int64")
    r_diam, r_ecc, r_conn, r_steps = _ref_solve(qg)
    assert (diam, connected, steps) == (r_diam, r_conn, r_steps)
    np.testing.assert_array_equal(ecc, r_ecc)
    assert reads == -(-steps // 3) + 1
    s_diam, s_conn = q.quotient_diameter(qg)
    assert (diam, connected) == (s_diam, s_conn)
    if qcase == "int64-path-2^30-1":
        assert diam == 5 * (2**30 - 1)


def test_device_quotient_through_backend_args_is_one_read():
    e, dec = _road_case()
    pe = EdgeList(e.n_nodes, e.src, e.dst, e.weight)
    dec = Decomposition(**{**dec.__dict__,
                           "final_c_dev": torch.from_numpy(dec.final_c),
                           "final_pathw_dev": torch.from_numpy(dec.final_pathw)})
    with guard.metered() as meter:
        dq = q.build_quotient_device(pe, dec, _Backend(e.src, e.dst, e.weight))
        assert meter.transfers == 0
        k, m, wmax, wsum = q.fetch_quotient_counters(dq)
    assert meter.transfers == 1
    host = q.build_quotient_numpy(pe, dec)
    assert (k, m) == (host.n_clusters, len(host.src))
    assert wsum == int(host.weight.sum())


@pytest.mark.parametrize("heavy", [False, True])
def test_bellman_ford_matches_reference_and_scipy(heavy):
    if heavy:
        n = 6
        u = np.arange(n - 1, dtype=np.int32)
        ref_e = RefEdgeList.from_undirected(n, u, u + 1,
                                            np.full(n - 1, 2**30 - 1, np.int32))
    else:
        ref_e = ref_gen.road_like(800, seed=4)
    e = EdgeList(ref_e.n_nodes, ref_e.src, ref_e.dst, ref_e.weight)
    got = sssp.bellman_ford(e, 0, device="cpu", chunk=5)
    want = ref_sssp.bellman_ford(ref_e, 0)
    np.testing.assert_array_equal(got.dist.astype(np.int64),
                                  np.asarray(want.dist, np.int64))
    assert got.supersteps == want.supersteps and got.inf == want.inf
    exact = shortest_path(to_scipy_csr(e), method="D", indices=[0])[0]
    np.testing.assert_array_equal(got.dist.astype(np.float64), exact)
    fp = sssp.farthest_point_lower_bound(
        torch.from_numpy(e.src), torch.from_numpy(e.dst),
        torch.from_numpy(e.weight), e.n_nodes, int(e.weight.max()),
        rounds=3, seed=2, chunk=5)
    assert (fp.lower, fp.connected) == ref_sssp.farthest_point_lower_bound(
        ref_e, rounds=3, seed=2)
    s0 = int(np.random.default_rng(2).integers(e.n_nodes))
    first = shortest_path(to_scipy_csr(e), method="D", indices=[s0])[0]
    assert fp.first_ecc == int(first.max()) and 1 <= fp.hops <= 3
    if heavy:
        assert got.dist.dtype == np.int64 and int(got.dist[-1]) == 5 * (2**30 - 1)


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_batched_bf_loop_matches_reference(chunk):
    r = np.random.default_rng(chunk)
    n, m, s = 60, 300, 5
    src = r.integers(0, n, m).astype(np.int32)
    dst = r.integers(0, n, m).astype(np.int32)
    w = r.integers(1, 2**35, m).astype(np.int64)
    w[:7] = INF64 + 3                                  # padding edges
    d0 = np.full((n, s), INF64, np.int64)
    d0[r.choice(n, s, replace=False), np.arange(s)] = 0
    with jax.experimental.enable_x64():
        rd, rk = ref_sssp.batched_bf_loop(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
            jnp.asarray(d0), jnp.int64(INF64), n)
        rd, rk = np.asarray(rd), int(rk)
    d, k, reads = sssp.batched_bf_loop(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        torch.from_numpy(d0), INF64, n, chunk)
    np.testing.assert_array_equal(d.numpy(), rd)
    assert k == rk and reads == max(1, -(-k // chunk))


def test_sssp_dtype_for_matches_reference():
    for n, wmax, delta in [(10, 5, 0), (3, 2**30 - 1, 0), (2, 2**30 - 1, 0),
                           (1000, 2**21, 0), (1000, 2**21, 10**9)]:
        dt, inf = sssp.sssp_dtype_for(n, wmax, delta)
        rdt, rinf = ref_sssp.sssp_dtype_for(n, wmax, delta)
        assert inf == rinf
        assert str(dt).split(".")[-1] == np.dtype(rdt).name

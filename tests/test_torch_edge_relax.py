"""The port's edge-relax superstep against the JAX package: the plain
PyTorch version must equal ``repro.kernels.edge_relax.ref.edge_relax_ref``
and the Pallas kernel run in interpret mode, exactly (all outputs are
int32). A CUDA-only case compares the hand-written kernel with the plain
version on the card; it skips where there is no GPU."""
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

from repro.kernels.edge_relax.ops import block_edges_host  # noqa: E402
from repro.kernels.edge_relax.ops import edge_relax as ref_edge_relax  # noqa: E402
from repro.kernels.edge_relax.ref import edge_relax_ref as jnp_relax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.edge_relax import kernel as kmod  # noqa: E402
from repro_torch.kernels.edge_relax.ops import (  # noqa: E402
    build_relax_graph,
    edge_relax,
    edge_relax_plain,
)

INF, BIG = 2**31 - 1, 2**30


def _problem(n, e, wmax, covered_frac, live_frac, seed, isolated=0):
    """Random planes in the reference's test style
    (``tests/test_kernels.py::_mk_relax_problem``); the last ``isolated``
    nodes get no in-edges."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(0, max(n - isolated, 1), e).astype(np.int32)
    w = r.integers(1, wmax + 1, e).astype(np.int32)
    d = np.full(n, INF, np.int32)
    live = r.random(n) < live_frac
    d[live] = r.integers(0, min(2 * wmax, BIG), live.sum())
    c = np.full(n, INF, np.int32)
    c[live] = r.integers(0, n, live.sum())
    p = np.full(n, INF, np.int32)
    p[live] = d[live]
    rw0 = np.full(n, BIG, np.int32)
    cov = (r.random(n) < covered_frac) & ~live
    rw0[cov] = r.integers(-wmax, 1, cov.sum())        # negative offsets
    rc = np.full(n, INF, np.int32)
    rc[cov] = r.integers(0, n, cov.sum())
    rp = np.full(n, INF, np.int32)
    rp[cov] = r.integers(0, min(4 * wmax, BIG), cov.sum())
    rp[cov & (r.random(n) < 0.2)] = INF               # relay with INF path
    delta = int(min(wmax, BIG))
    return src, dst, w, (d, c, p, rw0, rc, rp), delta


def _port_plain(src, dst, w, planes, delta, n):
    g = build_relax_graph(src, dst, w, n, "cpu")
    out = edge_relax([torch.from_numpy(x) for x in planes], g, delta)
    return [o.numpy() for o in out]


def _jnp_ref(src, dst, w, planes, delta, n):
    gathered = [jnp.asarray(x[src]) for x in planes]
    out = jnp_relax_ref(*gathered, jnp.asarray(w), jnp.asarray(dst),
                        jnp.bool_(True), jnp.int32(delta), n)
    return [np.asarray(o) for o in out]


def _pallas_interpret(src, dst, w, planes, delta, n):
    blk = block_edges_host(src, dst, w, n)
    n_pad = blk["n_pad_nodes"]
    padded = []
    for x, fill in zip(planes, (INF, INF, INF, BIG, INF, INF)):
        y = np.full(n_pad, fill, np.int32)
        y[:n] = x
        padded.append(jnp.asarray(y))
    out = ref_edge_relax(tuple(padded), jnp.asarray(blk["src"]),
                         jnp.asarray(blk["dst"]), jnp.asarray(blk["w"]),
                         jnp.asarray(blk["mask"]),
                         jnp.asarray(blk["block_tile"]), jnp.int32(delta),
                         blk["n_tiles"], impl="interpret")
    return [np.asarray(o)[:n] for o in out]


CASES = [
    # n, e, wmax, covered_frac, live_frac, isolated
    (100, 400, 16, 0.2, 0.3, 0),             # test_kernels cases
    (700, 3000, 100, 0.2, 0.3, 0),
    (1500, 2000, 2**20, 0.2, 0.3, 0),
    (63, 4000, 7, 0.2, 0.3, 0),
    (300, 1200, 2**30 - 1, 0.3, 0.3, 0),     # heaviest legal weights
    (257, 900, 50, 0.6, 0.2, 40),            # many relays, isolated tail
    (1, 3, 5, 0.0, 1.0, 0),                  # single node, self loops
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-e{c[1]}-w{c[2]}")
def test_plain_matches_jnp_ref_and_pallas_interpret(case):
    n, e, wmax, cov, live, iso = case
    src, dst, w, planes, delta = _problem(n, e, wmax, cov, live,
                                          seed=n + e, isolated=iso)
    port = _port_plain(src, dst, w, planes, delta, n)
    ref = _jnp_ref(src, dst, w, planes, delta, n)
    pal = _pallas_interpret(src, dst, w, planes, delta, n)
    for name, a, b, c in zip("dcp", port, ref, pal):
        np.testing.assert_array_equal(a, b, err_msg=f"plane {name} vs ref")
        np.testing.assert_array_equal(a, c, err_msg=f"plane {name} vs pallas")
    if iso:
        # nodes with no in-edges keep INF in all three planes
        for a in port:
            assert (a[n - iso:] == INF).all()


def test_csr_layout_is_dst_src_sorted():
    src, dst, w, _, _ = _problem(200, 1500, 30, 0.1, 0.1, seed=5, isolated=7)
    g = build_relax_graph(src, dst, w, 200, "cpu")
    order = np.lexsort((src, dst))
    np.testing.assert_array_equal(g.src.numpy(), src[order])
    np.testing.assert_array_equal(g.dst.numpy(), dst[order])
    np.testing.assert_array_equal(g.w.numpy(), w[order])
    rp = g.row_ptr.numpy()
    assert rp.dtype == np.int32 and rp[0] == 0 and rp[-1] == len(src)
    np.testing.assert_array_equal(np.diff(rp), np.bincount(dst, minlength=200))


def test_cpu_path_never_launches_and_kernel_wrapper_rejects_cpu():
    src, dst, w, planes, delta = _problem(64, 300, 9, 0.2, 0.3, seed=1)
    before = kmod.edge_relax_cuda.launches
    _port_plain(src, dst, w, planes, delta, 64)
    assert kmod.edge_relax_cuda.launches == before
    g = build_relax_graph(src, dst, w, 64, "cpu")
    with pytest.raises(ValueError, match="must be on"):
        kmod.edge_relax_cuda([torch.from_numpy(x) for x in planes],
                             g.row_ptr, g.src, g.w, delta)
    assert kmod.edge_relax_cuda.launches == before


def test_library_name_tracks_source_hash():
    a = _build.library_path(kmod.NAME, kmod.SOURCES)
    assert a == _build.library_path(kmod.NAME, kmod.SOURCES)
    assert a.parent == _build.BUILD_DIR and a.name.startswith("edge_relax-")
    src = _build.source_paths(kmod.SOURCES)[0].read_text()
    assert "edge_relax_launch" in src and "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-e{c[1]}-w{c[2]}")
def test_cuda_kernel_matches_plain(cuda_device, case):
    n, e, wmax, cov, live, iso = case
    src, dst, w, planes, delta = _problem(n, e, wmax, cov, live,
                                          seed=n + e, isolated=iso)
    g = build_relax_graph(src, dst, w, n, cuda_device)
    tp = [torch.from_numpy(x).to(cuda_device) for x in planes]
    before = kmod.edge_relax_cuda.launches
    out = edge_relax(tp, g, delta)
    torch.cuda.synchronize()
    assert kmod.edge_relax_cuda.launches == before + 1
    ref = edge_relax_plain(tp, g, delta)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)

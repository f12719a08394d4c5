"""The port's edge-relax superstep against the JAX package: the plain
PyTorch version must equal ``repro.kernels.edge_relax.ref.edge_relax_ref``
and the Pallas kernel run in interpret mode, exactly (all outputs are
int32). The graph layout's long-row list, and the tuple-min taken the way
the kernels split a row across lanes and blocks, are checked here too. A
CUDA-only case compares the hand-written kernel with the plain version on
the card; it skips where there is no GPU."""
import contextlib
import dataclasses
import re

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
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.edge_relax import kernel as kmod  # noqa: E402
from repro_torch.kernels.edge_relax.ops import (  # noqa: E402
    build_relax_graph,
    edge_relax,
    edge_relax_plain,
)
from repro_torch.kernels.edge_relax.ref import (  # noqa: E402
    edge_relax_candidates,
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
        kmod.edge_relax_cuda([torch.from_numpy(x) for x in planes], g,
                             delta)
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


def _degrees(ptr):
    return (ptr[1:] - ptr[:-1]).to(torch.int64)


def _expected_long(deg):
    """Rows with more than LONG_ROW edges, longest first, ties by id."""
    rows = [int(v) for v in torch.nonzero(deg > kmod.LONG_ROW).flatten()]
    return sorted(rows, key=lambda v: (-int(deg[v]), v))


def _threshold_rows():
    """Rows of exactly LONG_ROW in-edges (short), LONG_ROW + 1 (long) and
    around them, from a 50-node tail."""
    t = kmod.LONG_ROW
    degrees = [t, t + 1, t - 1, t + 1, t, 2 * t + 3, 1, 0]
    r = np.random.default_rng(5)
    dst = np.repeat(np.arange(len(degrees)), degrees).astype(np.int32)
    src = r.integers(len(degrees), len(degrees) + 50, dst.shape[0])
    return EdgeList(len(degrees) + 50, src.astype(np.int32), dst,
                    np.ones(dst.shape[0], np.int32))


# graph -> (maker, how many rows are long)
LAYOUT_GRAPHS = {
    "road": (lambda: gen.road_like(500, seed=1), 0),
    "rmat": (lambda: gen.social_like(14, seed=2), 15),
    "threshold": (_threshold_rows, 3),
    "isolated": (lambda: EdgeList(5, np.array([3, 3, 4], np.int32),
                                  np.array([1, 0, 0], np.int32),
                                  np.array([2, 2, 5], np.int32)), 0),
}


@pytest.mark.parametrize("graph", sorted(LAYOUT_GRAPHS))
def test_long_row_lists_are_the_rows_above_the_threshold(graph):
    """The long-row list holds exactly the rows with more than
    ``LONG_ROW`` in-edges (a row of exactly ``LONG_ROW`` is short),
    longest first, as int32, and is empty when no row is long. It is
    derived from the CSR: the constructor takes no list, and
    ``dataclasses.replace`` derives it again."""
    make, n_long = LAYOUT_GRAPHS[graph]
    e = make()
    g = build_relax_graph(e.src, e.dst, e.weight, e.n_nodes, "cpu")
    in_deg = _degrees(g.row_ptr)
    assert g.long_rows.dtype == torch.int32
    assert g.long_rows.tolist() == _expected_long(in_deg)
    assert len(g.long_rows) == n_long
    if graph == "threshold":
        assert g.long_rows.tolist() == [5, 1, 3]
    cut = dataclasses.replace(g, row_ptr=torch.minimum(
        g.row_ptr, torch.tensor(kmod.LONG_ROW, dtype=torch.int32)))
    assert cut.long_rows.numel() == 0
    with pytest.raises(TypeError):
        type(g)(g.n_nodes, g.row_ptr, g.src, g.dst, g.w, g.long_rows)


def test_long_row_threshold_is_the_kernels_constant():
    """The layout lists rows by ``LONG_ROW``; the kernels split rows by
    ``kLongRow`` in the header both include: the two must be one number."""
    header = _build.source_paths(
        ("edge_relax/csrc/relax_scan.cuh",))[0].read_text()
    m = re.search(r"constexpr int kLongRow = (\d+);", header)
    assert m and int(m.group(1)) == kmod.LONG_ROW
    for source in (*kmod.SOURCES, *kmod.MEGA_SOURCES):
        text = _build.source_paths((source,))[0].read_text()
        assert "kLongRow" in text and "long_min" not in text


def _lex_min(items):
    return min(items, default=(INF, INF, INF))


def _xor_tree(parts):
    """The kernels' shuffle tree: at each offset every lane takes the min
    of its value and its xor partner's."""
    parts = list(parts)
    off = len(parts) // 2
    while off:
        parts = [min(parts[i], parts[i ^ off]) for i in range(len(parts))]
        off //= 2
    return parts[0]


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_split_tuple_min_is_order_free(lanes, order):
    """The tuple-min taken the way the kernels split it (per-lane partial
    mins over strided edges, an xor tree over a row's lanes; a long row's
    256 thread partials reduced per warp, then the warps' results combined
    in forward, reverse or shuffled order) is byte-equal to the plain
    version and to the JAX reference: the redesign rests on that."""
    n, e = 300, 3000
    src, dst, w, planes, delta = _problem(n, e, 40, 0.3, 0.4, seed=lanes,
                                          isolated=5)
    hub = np.random.default_rng(3).integers(0, n, 2000).astype(np.int32)
    src = np.concatenate([src, hub])                 # row 0: a long row
    dst = np.concatenate([dst, np.zeros(2000, np.int32)])
    w = np.concatenate([w, np.full(2000, 7, np.int32)])
    g = build_relax_graph(src, dst, w, n, "cpu")
    tp = [torch.from_numpy(x) for x in planes]
    idx = g.src.to(torch.int64)
    cd, cc, cp = (x.tolist() for x in edge_relax_candidates(
        *[t[idx] for t in tp], g.w, True, delta))
    cand = list(zip(cd, cc, cp))
    rng = np.random.default_rng(lanes)
    got = []
    for v in range(n):
        e0, e1 = int(g.row_ptr[v]), int(g.row_ptr[v + 1])
        if e1 - e0 > kmod.LONG_ROW:
            threads = [_lex_min(cand[i] for i in range(e0 + t, e1, 256))
                       for t in range(256)]
            warps = [_xor_tree(threads[k:k + 32]) for k in range(0, 256, 32)]
            if order == "reverse":
                warps = warps[::-1]
            elif order == "shuffled":
                warps = [warps[i] for i in rng.permutation(len(warps))]
            acc = (INF, INF, INF)
            for part in warps:
                acc = min(acc, part)
        else:
            parts = [_lex_min(cand[i] for i in range(e0 + l, e1, lanes))
                     for l in range(lanes)]
            if order == "reverse":
                parts = parts[::-1]
            elif order == "shuffled":
                parts = [parts[i] for i in rng.permutation(lanes)]
            acc = _xor_tree(parts)
        got.append(acc)
    got = [np.array(x, np.int32) for x in zip(*got)]
    assert g.long_rows.tolist() == [0]
    for a, b, c in zip(got, edge_relax_plain(tp, g, delta),
                       _jnp_ref(src, dst, w, planes, delta, n)):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, c)

"""The port's ``segment_mm`` (``repro_torch/kernels/segment_mm``) against
the JAX package's: the plain version (through ``ops.segment_mm`` and
``ops.segment_mm_csr`` on CPU tensors) against the reference's
``segment_mm(..., impl="ref")`` (``jax.ops.segment_sum``) and its Pallas
kernel in interpret mode (``impl="interpret"``), over the case table of
``kernels/segment_mm/cases.py`` (which the card's checks share: the
reference's own sweep, D = 1 to 256, no edges, one node, duplicates and
self-loops, empty rows, rows of 1,024 and 1,025 edges and of TILE and
TILE + 1, 40,000-edge hubs); the float32 rule the card holds the kernel
to, which must reject both planted faults; the CSR layout against the
reference's ``block_edges_for_mm`` order, and its crossing rows against a
numpy merge-path partition; ``TILE`` against the source's ``kTile``; a
float64 emulation of the kernel's piece-and-carry order (pieces, the
consumer groups' runs, tails, heads and the fix-up) under the rule; the
dispatch of the entry points; the CUDA wrapper's refusals, which come
before anything is built; and the gradient: ``transpose_layout`` of
``csr_layout``, ``edge_layout`` and ``irrep_layout`` against a numpy
transpose of their items, ``torch.autograd.gradcheck`` of
``segment_mm_csr`` in float64 over non-symmetric coefficients (a
coefficient permutation that is wrong fails it), and its refusals (a
coefficient that requires grad; no transposed layout). The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the rule of ``cases.py``, ``|o - r| <= 16 u sqrt(K) A`` with
``A`` the same sum on absolute values, K the row's length and u = 2^-24.
Both sides sum the same float32 terms, the interpret mode in another order;
measured here, the rule reads 0 against ``segment_sum`` (the same order:
bit-equal), at most 0.12 against the interpret mode, and above 10 on the
faults.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import re
import types
from pathlib import Path

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import GNN_SHAPES as REF_GNN_SHAPES  # noqa: E402
from repro.data.pipeline import gnn_full_graph_batch  # noqa: E402
from repro.kernels.segment_mm.ops import block_edges_for_mm  # noqa: E402
from repro.kernels.segment_mm.ops import segment_mm as ref_segment_mm  # noqa: E402
from repro_torch.kernels.segment_mm import kernel as smod  # noqa: E402
from repro_torch.kernels.segment_mm.cases import (CASES, FAULT_CASE,  # noqa: E402
                                                  case_inputs,
                                                  drop_one_chunk,
                                                  drop_one_edge, excess,
                                                  rule_excess)
from repro_torch.kernels.segment_mm.ops import (TILE, CsrLayout,  # noqa: E402
                                                crossing_rows, csr_layout,
                                                segment_mm, segment_mm_csr,
                                                transpose_layout)
from repro_torch.kernels.segment_mm.ref import segment_mm_ref  # noqa: E402


def _torch_case(name):
    x, src, dst, coeff, n = case_inputs(name)
    return (torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(coeff), n)


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(name, impl):
    x, src, dst, coeff, n = case_inputs(name)
    tx, ts, td, tc, _ = _torch_case(name)
    got = segment_mm(tx, ts, td, tc, n)
    if impl == "ref":
        want = ref_segment_mm(jnp.asarray(x), jnp.asarray(src),
                              jnp.asarray(dst), jnp.asarray(coeff), n,
                              impl="ref")
    else:
        want = ref_segment_mm(x, src, dst, coeff, n, impl="interpret")
    want = torch.from_numpy(np.array(want))
    assert got.shape == want.shape == (n, x.shape[1])
    assert got.dtype == torch.float32
    assert rule_excess(got, want, tx, ts, td, tc, n) <= 1.0
    # the CSR path sums the same terms in the layout's order
    layout = csr_layout(ts, td, n)
    csr = segment_mm_csr(tx, layout, tc[layout.perm])
    assert rule_excess(csr, want, tx, ts, td, tc, n) <= 1.0


@pytest.mark.parametrize("name", ["hub-40000", "hub-40000-d7",
                                  "hub-5000-d128", "row-past-chunk"])
def test_rule_rejects_the_planted_faults(name):
    """Against the exact sum (float64): the float32 plain version reads far
    below 1; one edge dropped from a row of average length, or the middle
    chunk of the longest (split) row, reads above 1."""
    x, src, dst, coeff, n = _torch_case(name)
    exact = segment_mm_ref(x.double(), src, dst, coeff.double(), n)
    assert rule_excess(segment_mm_ref(x, src, dst, coeff, n), exact,
                       x, src, dst, coeff, n) < 0.2
    assert rule_excess(drop_one_edge(x, src, dst, coeff, n), exact,
                       x, src, dst, coeff, n) > 100.0
    chunk_fault = rule_excess(drop_one_chunk(x, src, dst, coeff, n), exact,
                              x, src, dst, coeff, n)
    assert chunk_fault > (5.0 if name == FAULT_CASE else 1.0)


def test_drop_one_chunk_needs_a_split_row():
    x, src, dst, coeff, n = _torch_case("row-at-chunk")
    with pytest.raises(ValueError, match="not split"):
        drop_one_chunk(x, src, dst, coeff, n)


def test_excess_counts_zero_allowance():
    z = torch.zeros(2, 3)
    assert excess(z, z, z) == 0.0
    assert excess(z + 1e-30, z, z) == float("inf")


def _np_crossing_rows(row_ptr, tile):
    """The rows cut by a piece boundary, from the merge-path partition in
    numpy: boundary d starts at row X = #{r : row_ptr[r + 1] + r < d} and
    edge Y = d - X, and cuts row X when X < N and row_ptr[X] < Y."""
    n = len(row_ptr) - 1
    ends = row_ptr[1:] + np.arange(n)
    d = np.arange(tile, n + int(row_ptr[-1]), tile)
    xs = np.searchsorted(ends, d, side="left")
    cut = (xs < n) & (row_ptr[np.minimum(xs, n)] < d - xs)
    return np.unique(xs[cut])


def _check_layout(src, dst, n, tile=TILE):
    layout = csr_layout(torch.from_numpy(src), torch.from_numpy(dst), n,
                        tile=tile)
    blk = block_edges_for_mm(src, dst, n)
    np.testing.assert_array_equal(layout.perm.numpy(), blk["perm"])
    deg = np.bincount(dst, minlength=n)
    np.testing.assert_array_equal(layout.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(deg)]))
    np.testing.assert_array_equal(layout.col.numpy(), src[blk["perm"]])
    np.testing.assert_array_equal(layout.row.numpy(), dst[blk["perm"]])
    np.testing.assert_array_equal(
        layout.crossing_rows.numpy(),
        _np_crossing_rows(layout.row_ptr.numpy(), tile))
    assert layout.tile == tile
    assert layout.row_ptr.dtype == torch.int64
    assert layout.col.dtype == layout.row.dtype == torch.int32
    assert layout.crossing_rows.dtype == torch.int32
    np.testing.assert_array_equal(layout.in_degree().numpy(), deg)
    return layout


@pytest.mark.parametrize("name", ["duplicates-self-loops", "empty-rows",
                                  "row-past-chunk", "hub-40000",
                                  "no-edges", "one-node"])
def test_layout_matches_reference_order(name):
    _, src, dst, _, n = case_inputs(name)
    _check_layout(src, dst, n)


@pytest.mark.parametrize("tile", [TILE, 32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_crossing_rows_match_the_merge_path(name, tile):
    """Every case's crossing rows (derived per row from the items' piece
    numbers) against the numpy merge-path partition's boundaries."""
    _, src, dst, _, n = case_inputs(name)
    layout = _check_layout(src, dst, n, tile=tile)
    deg = layout.in_degree()
    if n and int(deg.max()) + 1 > tile:   # a row longer than a piece
        assert int(deg.argmax()) in layout.crossing_rows.tolist()


@pytest.mark.parametrize("tile", [TILE, 64])
def test_layout_of_the_skewed_gcn_graph(tile):
    """The reference's own full-graph batch (endpoints floor(n u^2), so
    skewed): its crossing rows at the default tile and at 64."""
    shape = REF_GNN_SHAPES[0]
    b = gnn_full_graph_batch(None, shape, seed=0)
    layout = _check_layout(b["src"], b["dst"], shape.n_nodes, tile=tile)
    n_items = shape.n_nodes + len(b["src"])
    assert 0 < layout.crossing_rows.numel() < -(-n_items // tile)


def _as_namespace(layout, **over):
    """A layout's fields as a plain namespace, with ``over`` replacing some:
    a layout whose derived ``crossing_rows`` no ``CsrLayout`` would hold."""
    fields = {f.name: getattr(layout, f.name)
              for f in dataclasses.fields(layout)}
    return types.SimpleNamespace(**{**fields, **over})


def test_replace_derives_crossing_rows_again():
    """``crossing_rows`` follows ``row_ptr`` and ``tile``: a layout
    replaced to another tile holds that tile's crossing rows, and a
    constructor cannot be handed a list of its own."""
    _, src, dst, _, n = case_inputs("hub-40000")
    layout = csr_layout(torch.from_numpy(src), torch.from_numpy(dst), n)
    for tile in (32, 1024, TILE):
        small = dataclasses.replace(layout, tile=tile)
        assert small.tile == tile
        assert torch.equal(small.crossing_rows,
                           crossing_rows(layout.row_ptr, tile))
        np.testing.assert_array_equal(
            small.crossing_rows.numpy(),
            _np_crossing_rows(layout.row_ptr.numpy(), tile))
    with pytest.raises(TypeError):
        CsrLayout(n, layout.row_ptr, layout.col, layout.row, layout.perm,
                  TILE, layout.crossing_rows)
    with pytest.raises(ValueError):
        dataclasses.replace(layout, crossing_rows=layout.crossing_rows[:1])
    with pytest.raises(ValueError, match="tile"):
        dataclasses.replace(layout, tile=0)


def test_tile_is_the_kernels_piece_size():
    """The layout cuts pieces by ``TILE``; the kernel sizes its stages by
    ``kTile``: the two must be one number."""
    src = (Path(smod.__file__).parent / "csrc" / "segment_mm.cu").read_text()
    m = re.search(r"constexpr int kTile = (\d+);", src)
    assert m and int(m.group(1)) == TILE == smod.TILE


def test_layout_rejects_bad_edges():
    src = torch.tensor([0, 1, 5], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        csr_layout(src, dst, 5)
    with pytest.raises(ValueError, match="outside"):
        csr_layout(dst, -src, 5)
    with pytest.raises(ValueError, match="1-d"):
        csr_layout(src, dst[:2], 6)
    with pytest.raises(ValueError, match="tile"):
        csr_layout(src, dst, 6, tile=0)
    with pytest.raises(ValueError, match="tile"):
        csr_layout(src, dst, 6, tile=TILE + 1)


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    x, src, dst, coeff, n = _torch_case("hub-5000-d128")
    layout = csr_layout(src, dst, n)
    before = smod.segment_mm_cuda.launches
    out = segment_mm_csr(x, layout, coeff[layout.perm])
    assert smod.segment_mm_cuda.launches == before
    torch.testing.assert_close(
        out, segment_mm_ref(x, layout.col, layout.row, coeff[layout.perm],
                            n), rtol=0, atol=0)
    torch.testing.assert_close(segment_mm(x, src, dst, coeff, n, impl="ref"),
                               segment_mm_ref(x, src, dst, coeff, n),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        segment_mm(x, src, dst, coeff, n, impl="interpret")
    with pytest.raises(ValueError, match="impl"):
        segment_mm_csr(x, layout, coeff, impl="pallas")


def test_cuda_wrapper_refuses_before_building():
    """float64, shapes that do not agree, an unsupported width or tile, a
    column stride, a row stride below D, wrong index types and CPU tensors
    are all refused by the checks, so the library is never built or loaded
    here."""
    x, src, dst, coeff, n = _torch_case("sweep-257-513-16")
    layout = csr_layout(src, dst, n)
    cs = coeff[layout.perm]
    before = smod.segment_mm_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        smod.segment_mm_cuda(x.double(), layout, cs)
    with pytest.raises(ValueError, match="int64"):
        smod.segment_mm_cuda(x, dataclasses.replace(
            layout, row_ptr=layout.row_ptr.int()), cs)
    with pytest.raises(ValueError, match="int32"):
        smod.segment_mm_cuda(x, dataclasses.replace(
            layout, col=layout.col.long()), cs)
    with pytest.raises(ValueError, match="int32"):
        smod.segment_mm_cuda(x, _as_namespace(
            layout, crossing_rows=layout.crossing_rows.long()), cs)
    with pytest.raises(ValueError, match="do not agree"):
        smod.segment_mm_cuda(x, layout, cs[:-1])
    with pytest.raises(ValueError, match="2-d"):
        smod.segment_mm_cuda(x[0], layout, cs)
    with pytest.raises(ValueError, match="D <="):
        smod.segment_mm_cuda(torch.zeros(n, 257), layout, cs)
    with pytest.raises(ValueError, match="tile"):
        smod.segment_mm_cuda(x, _as_namespace(layout, tile=0), cs)
    with pytest.raises(ValueError, match="tile"):
        smod.segment_mm_cuda(x, _as_namespace(layout, tile=TILE + 1), cs)
    with pytest.raises(ValueError, match="unit column stride"):
        smod.segment_mm_cuda(x.t().contiguous().t(), layout, cs)
    with pytest.raises(ValueError, match="row stride >= D"):
        smod.segment_mm_cuda(torch.zeros(n * 8 + 8).as_strided((n, 16), (8, 1)),
                             layout, cs)
    with pytest.raises(ValueError, match="CUDA"):
        smod.segment_mm_cuda(x, layout, cs)
    # a view of padded rows, and a base that is not 16-byte aligned (read a
    # float at a time), pass every check but the device's
    with pytest.raises(ValueError, match="CUDA"):
        smod.segment_mm_cuda(torch.zeros(n, 20)[:, :16], layout, cs)
    with pytest.raises(ValueError, match="CUDA"):
        smod.segment_mm_cuda(torch.zeros(n * 16 + 1)[1:].view(n, 16),
                             layout, cs)
    assert smod.segment_mm_cuda.launches == before
    assert smod.load_library.cache_info().currsize == 0


def test_wrapper_reads_whole_chunks_only_inside_storage():
    """16-byte reads of x need a 16-byte aligned base, a row stride of 4k
    floats, and D rounded up to 4 from the last row inside the storage."""
    assert smod._reads_whole_chunks(torch.zeros(10, 16))
    assert smod._reads_whole_chunks(torch.zeros(10, 8)[:, :7])
    assert not smod._reads_whole_chunks(torch.zeros(10, 7))
    assert not smod._reads_whole_chunks(torch.zeros(10, 9)[:, :7])
    assert not smod._reads_whole_chunks(
        torch.zeros(10 * 8 - 1).as_strided((10, 7), (8, 1)))
    assert not smod._reads_whole_chunks(torch.zeros(0, 16))
    assert not smod._reads_whole_chunks(torch.zeros(10 * 16 + 1)[1:].view(
        10, 16))


# -- the kernel's piece-and-carry order, emulated in float64 ----------------

def emulate_pieces(x, layout, coeff, groups):
    """The kernel's order of summation in float64: pieces of
    ``layout.tile`` merged items; in each, ``groups`` runs of items split
    by merge path; a row that ends in a run and began there written at
    once; each run's tail (the row open at its end) kept; a row that ends
    in a run after beginning in an earlier one summed from those runs'
    tails, in order, and its own part, and written if it began in the
    piece, else put in the piece's head slot; the row open at the piece's
    end put in its tail slot; then the fix-up over ``crossing_rows``
    (tails of the pieces a row spans, then the head of the piece it ends
    in). Returns y and how many times each row was written."""
    rp = layout.row_ptr.numpy()
    col = layout.col.numpy()
    row = layout.row.numpy()
    w = coeff.numpy().astype(np.float64)
    xs = x.numpy().astype(np.float64)
    tile = layout.tile
    n, d = len(rp) - 1, xs.shape[1]
    ne = n + len(col)
    ends = rp[1:] + np.arange(n)

    def rows_before(pos):
        return int(np.searchsorted(ends, pos, side="left"))

    def part(r, lo, hi):
        """Row r's terms among edges [lo, hi)."""
        lo, hi = max(lo, int(rp[r])), min(hi, int(rp[r + 1]))
        if hi <= lo:
            return np.zeros(d)
        return (w[lo:hi, None] * xs[col[lo:hi]]).sum(0)

    n_pieces = -(-ne // tile)
    y = np.full((n, d), np.nan)
    writes = np.zeros(n, np.int64)
    heads = np.full((n_pieces, d), np.nan)
    tails = np.full((n_pieces, d), np.nan)

    def write(r, v):
        y[r] = v
        writes[r] += 1

    for p in range(n_pieces):
        dp, dq = p * tile, min(p * tile + tile, ne)
        xp, xq = rows_before(dp), rows_before(dq)
        yp = dp - xp
        run_tail, run_open = [], []
        for k in range(groups):
            g0 = dp + (dq - dp) * k // groups
            g1 = dp + (dq - dp) * (k + 1) // groups
            x0, x1 = rows_before(g0), rows_before(g1)
            y0, y1 = g0 - x0, g1 - x1
            assert np.all(row[y0:y1] >= x0) and np.all(row[y0:y1] <= x1)
            for r in range(x0, x1):
                if r == x0 and rp[x0] < y0:    # began before this run
                    total = sum(run_tail[m] for m in range(
                        _first_open(run_open, k, x0), k)) + part(r, y0, y1)
                    if rp[x0] >= yp:
                        write(r, total)
                    else:
                        heads[p] = total
                else:
                    write(r, part(r, y0, y1))
            run_tail.append(part(x1, y0, y1) if x1 < n else np.zeros(d))
            run_open.append(x1)
        if xq < n:
            tails[p] = sum(run_tail[m] for m in range(
                _first_open(run_open, groups, xq), groups))
    for r in layout.crossing_rows.tolist():
        first, last = (rp[r] + r) // tile, (rp[r + 1] + r) // tile
        write(r, tails[first:last].sum(0) + heads[last])
    return torch.from_numpy(y), writes


def _first_open(run_open, k, r):
    """The first of the runs before run k that all end with row r open."""
    m = k
    while m > 0 and run_open[m - 1] == r:
        m -= 1
    return m


def _graph(degrees, d, seed):
    """Rows with the given in-degrees (sources uniform), x and coeff."""
    r = np.random.default_rng(seed)
    n = len(degrees)
    dst = np.repeat(np.arange(n), degrees).astype(np.int32)
    src = r.integers(0, n, len(dst)).astype(np.int32)
    x = r.standard_normal((n, d)).astype(np.float32)
    coeff = r.standard_normal(len(dst)).astype(np.float32)
    return x, src, dst, coeff, n


def _emulation_graphs(tile):
    """name -> (graph, tile): empty rows between and around pieces; a row
    over three pieces that begins mid-piece; rows of exactly ``tile`` and
    ``tile + 1`` edges."""
    t = 32
    empty_around = [0] * 40 + [3, 0, 0, 5, 9, 0, 1] * 6 + [0] * 45
    # 10 rows of 2 edges put row 10's first edge at item 30, mid-piece;
    # its 50 edges and its end (items 30 to 80) span pieces 0, 1 and 2
    three = [2] * 10 + [50] + [1] * 20
    exact = [1, 0, 2] + [tile] + [0, 3] + [tile + 1] + [1] * 5
    return {"empty-rows-around-pieces": (_graph(empty_around, 5, 1), t),
            "row-over-three-pieces": (_graph(three, 16, 2), t),
            "rows-of-tile-and-tile+1": (_graph(exact, 8, 3), tile)}


@pytest.mark.parametrize("groups", [1, 7, 64])
@pytest.mark.parametrize("name", ["empty-rows-around-pieces",
                                  "row-over-three-pieces",
                                  "rows-of-tile-and-tile+1",
                                  "rows-of-32-and-33", "hub-40000",
                                  "row-past-tile"])
def test_piece_and_carry_order_emulated(name, groups):
    """The kernel's piece-and-carry order, emulated in float64 on the CPU,
    writes every row exactly once and lies within the float32 rule of the
    plain version (so no partial is lost or counted twice)."""
    if name in CASES:
        x, src, dst, coeff, n = case_inputs(name)
        tile = TILE
    elif name == "rows-of-32-and-33":
        (x, src, dst, coeff, n), tile = _emulation_graphs(32)[
            "rows-of-tile-and-tile+1"]
    else:
        (x, src, dst, coeff, n), tile = _emulation_graphs(TILE)[name]
    tx, ts, td, tc = (torch.from_numpy(a) for a in (x, src, dst, coeff))
    layout = csr_layout(ts, td, n, tile=tile)
    cs = tc[layout.perm]
    got, writes = emulate_pieces(tx, layout, cs, groups)
    assert np.all(writes == 1)
    want = segment_mm_ref(tx, ts, td, tc, n)
    assert rule_excess(got, want, tx, ts, td, tc, n) <= 1.0
    if name == "row-over-three-pieces":
        r = 10
        first = (int(layout.row_ptr[r]) + r) // tile
        last = (int(layout.row_ptr[r + 1]) + r) // tile
        assert (int(layout.row_ptr[r]) + r) % tile and last - first == 2
        assert r in layout.crossing_rows.tolist()
    if name == "empty-rows-around-pieces":
        deg = layout.in_degree()
        ends = layout.row_ptr[1:] + torch.arange(n)
        # some piece boundary falls among empty rows
        assert any(int(deg[int(torch.searchsorted(ends, b))]) == 0
                   for b in range(tile, n + len(src), tile))


def test_emulation_catches_a_lost_tail():
    """The emulation is sharp: dropping one piece's tail slot of a crossing
    row breaks the rule."""
    x, src, dst, coeff, n = case_inputs("hub-40000")
    tx, ts, td, tc = (torch.from_numpy(a) for a in (x, src, dst, coeff))
    layout = csr_layout(ts, td, n)
    hub = int(layout.in_degree().argmax())
    rows = [r for r in layout.crossing_rows.tolist() if r != hub]
    lossy = _as_namespace(
        layout, crossing_rows=torch.tensor(rows, dtype=torch.int32))
    got, writes = emulate_pieces(tx, lossy, tc[layout.perm], 64)
    assert writes[hub] == 0 and np.isnan(got[hub].numpy()).all()


def _graph_for_grad(seed, n=40, e=300):
    """Edges with empty rows, self-loops and duplicates, and per-edge
    coefficients in no symmetric pattern."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(0, n - 8, e).astype(np.int32)
    dst[:10] = src[:10]
    src[-15:], dst[-15:] = src[:15], dst[:15]
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(r.uniform(0.5, 2.0, e)), n)


def _numpy_transpose(layout, n_src):
    """``(row_ptr, col, perm)`` of the transposed items, from numpy: the
    items sorted by (source, destination, forward position)."""
    col, row = layout.col.numpy(), layout.row.numpy()
    order = np.lexsort((np.arange(len(col)), row, col))
    row_ptr = np.searchsorted(col[order], np.arange(n_src + 1))
    return row_ptr, row[order], order


@pytest.mark.parametrize("which", ["csr", "edge", "irrep"])
def test_transpose_layout_matches_numpy(which):
    from repro_torch.models.gnn import edge_layout, irrep_layout
    src, dst, _, n = _graph_for_grad(0)
    layout = csr_layout(src, dst, n)
    n_src = n
    if which == "edge":
        layout, n_src = edge_layout(layout), src.numel()
    elif which == "irrep":
        layout, n_src = irrep_layout(layout, 9), 9 * src.numel()
    lt = transpose_layout(layout, n_src, gathers_once=which != "csr")
    row_ptr, col, perm = _numpy_transpose(layout, n_src)
    assert lt.n_nodes == n_src and lt.tile == layout.tile
    assert np.array_equal(lt.row_ptr.numpy(), row_ptr)
    assert np.array_equal(lt.col.numpy(), col)
    assert np.array_equal(lt.perm.numpy(), perm)
    assert lt.col.dtype == lt.row.dtype == torch.int32
    assert lt.row_ptr.dtype == lt.perm.dtype == torch.int64
    assert np.array_equal(lt.row.numpy(), np.repeat(np.arange(n_src),
                                                    np.diff(row_ptr)))
    assert torch.equal(lt.crossing_rows, crossing_rows(lt.row_ptr, lt.tile))
    if which != "csr":
        assert (np.diff(row_ptr) == 1).all()
        with pytest.raises(ValueError, match="once"):
            transpose_layout(layout, n_src + 1, gathers_once=True)
    else:
        with pytest.raises(ValueError, match="outside"):
            transpose_layout(layout, int(src.max()))


@pytest.mark.parametrize("norm", ["sym", "none", "random"])
def test_gradcheck_over_the_transposed_layout(norm):
    """The Function's gradient in x against finite differences (float64,
    D = 3) at GCN's two coefficient forms and at random ones; with the
    transposed coefficients taken in the forward order instead (a wrong
    permutation), the same check fails."""
    from repro_torch.models.gnn import gcn_norm
    src, dst, coeff_in, n = _graph_for_grad(1)
    layout = csr_layout(src, dst, n)
    if norm == "random":
        coeff = coeff_in[layout.perm]
    else:
        coeff = gcn_norm(layout, norm)[1].double()
    lt = transpose_layout(layout, n)
    x = torch.randn(n, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2),
                    requires_grad=True)

    def fn(v):
        return segment_mm_csr(v, layout, coeff, layout_t=lt)

    assert torch.autograd.gradcheck(fn, (x,))
    wrong = dataclasses.replace(lt, perm=torch.arange(lt.perm.numel()))
    assert not torch.autograd.gradcheck(
        lambda v: segment_mm_csr(v, layout, coeff, layout_t=wrong), (x,),
        raise_exception=False)


def test_gradient_refusals_and_no_grad_paths():
    src, dst, coeff_in, n = _graph_for_grad(3)
    layout = csr_layout(src, dst, n)
    coeff = coeff_in[layout.perm]
    x = torch.randn(n, 4, dtype=torch.float64)
    want = segment_mm_csr(x, layout, coeff)
    with pytest.raises(ValueError, match="coeff requires grad"):
        segment_mm_csr(x, layout, coeff.clone().requires_grad_())
    with pytest.raises(ValueError, match="transpose_layout"):
        segment_mm_csr(x.clone().requires_grad_(), layout, coeff)
    with torch.no_grad():
        got = segment_mm_csr(x.clone().requires_grad_(), layout,
                             coeff.clone().requires_grad_())
    assert torch.equal(got, want) and not got.requires_grad
    lt = transpose_layout(layout, n)
    y = segment_mm_csr(x.clone().requires_grad_(), layout, coeff,
                       layout_t=lt)
    assert torch.equal(y.detach(), want) and y.requires_grad
    # the flat entry point differentiates too (the plain version's own
    # autograd on the CPU)
    xs = x.clone().requires_grad_()
    segment_mm(xs, src, dst, coeff_in, n).sum().backward()
    xt = x.clone().requires_grad_()
    segment_mm_csr(xt, layout, coeff, layout_t=lt).sum().backward()
    assert torch.allclose(xs.grad, xt.grad, rtol=1e-14, atol=1e-14)

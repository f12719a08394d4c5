"""The port's ``segment_mm`` (``repro_torch/kernels/segment_mm``) against
the JAX package's: the plain version (through ``ops.segment_mm`` and
``ops.segment_mm_csr`` on CPU tensors) against the reference's
``segment_mm(..., impl="ref")`` (``jax.ops.segment_sum``) and its Pallas
kernel in interpret mode (``impl="interpret"``), over the case table of
``kernels/segment_mm/cases.py`` (which the card's checks share: the
reference's own sweep, D = 1 to 256, no edges, one node, duplicates and
self-loops, empty rows, rows at and past the chunk length, 40,000-edge
hubs); the float32 rule the card holds the kernel to, which must reject
both planted faults; the CSR layout against the reference's
``block_edges_for_mm`` order; the dispatch of the entry points; and the
CUDA wrapper's refusals, which come before anything is built. The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the rule of ``cases.py``, ``|o - r| <= 16 u sqrt(K) A`` with
``A`` the same sum on absolute values, K the row's length and u = 2^-24.
Both sides sum the same float32 terms, the interpret mode in another order;
measured here, the rule reads 0 against ``segment_sum`` (the same order:
bit-equal), at most 0.12 against the interpret mode, and above 10 on the
faults.
"""
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
from repro_torch.kernels.segment_mm.ops import (CHUNK, csr_layout,  # noqa: E402
                                                segment_mm, segment_mm_csr)
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


def _check_layout(src, dst, n, chunk=CHUNK):
    layout = csr_layout(torch.from_numpy(src), torch.from_numpy(dst), n,
                        chunk=chunk)
    blk = block_edges_for_mm(src, dst, n)
    np.testing.assert_array_equal(layout.perm.numpy(), blk["perm"])
    deg = np.bincount(dst, minlength=n)
    np.testing.assert_array_equal(layout.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(deg)]))
    np.testing.assert_array_equal(layout.col.numpy(), src[blk["perm"]])
    np.testing.assert_array_equal(layout.row.numpy(), dst[blk["perm"]])
    np.testing.assert_array_equal(layout.long_rows.numpy(),
                                  np.nonzero(deg > chunk)[0])
    assert layout.row_ptr.dtype == torch.int64
    assert layout.col.dtype == layout.row.dtype == torch.int32
    assert layout.long_rows.dtype == torch.int32
    np.testing.assert_array_equal(layout.in_degree().numpy(), deg)
    return layout


@pytest.mark.parametrize("name", ["duplicates-self-loops", "empty-rows",
                                  "row-past-chunk", "hub-40000",
                                  "no-edges", "one-node"])
def test_layout_matches_reference_order(name):
    _, src, dst, _, n = case_inputs(name)
    _check_layout(src, dst, n)


def test_layout_of_the_skewed_gcn_graph():
    """The reference's own full-graph batch (endpoints floor(n u^2), so
    skewed), with a small chunk so that it has long rows."""
    shape = REF_GNN_SHAPES[0]
    b = gnn_full_graph_batch(None, shape, seed=0)
    layout = _check_layout(b["src"], b["dst"], shape.n_nodes, chunk=64)
    assert 0 < layout.long_rows.numel() < 100


def test_layout_rejects_bad_edges():
    src = torch.tensor([0, 1, 5], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        csr_layout(src, dst, 5)
    with pytest.raises(ValueError, match="outside"):
        csr_layout(dst, -src, 5)
    with pytest.raises(ValueError, match="1-d"):
        csr_layout(src, dst[:2], 6)
    with pytest.raises(ValueError, match="chunk"):
        csr_layout(src, dst, 6, chunk=0)


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
    """float64, shapes that do not agree, an unsupported width, a strided
    view, wrong index types and CPU tensors are all refused by the checks,
    so the library is never built or loaded here."""
    x, src, dst, coeff, n = _torch_case("sweep-257-513-16")
    layout = csr_layout(src, dst, n)
    rp, col, lr = layout.row_ptr, layout.col, layout.long_rows
    cs = coeff[layout.perm]
    before = smod.segment_mm_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        smod.segment_mm_cuda(x.double(), rp, col, cs, lr, CHUNK)
    with pytest.raises(ValueError, match="int64"):
        smod.segment_mm_cuda(x, rp.int(), col, cs, lr, CHUNK)
    with pytest.raises(ValueError, match="int32"):
        smod.segment_mm_cuda(x, rp, col.long(), cs, lr, CHUNK)
    with pytest.raises(ValueError, match="do not agree"):
        smod.segment_mm_cuda(x, rp, col, cs[:-1], lr, CHUNK)
    with pytest.raises(ValueError, match="2-d"):
        smod.segment_mm_cuda(x[0], rp, col, cs, lr, CHUNK)
    with pytest.raises(ValueError, match="D <="):
        smod.segment_mm_cuda(torch.zeros(n, 257), rp, col, cs, lr, CHUNK)
    with pytest.raises(ValueError, match="chunk"):
        smod.segment_mm_cuda(x, rp, col, cs, lr, 0)
    with pytest.raises(ValueError, match="contiguous"):
        smod.segment_mm_cuda(x.t().contiguous().t(), rp, col, cs, lr, CHUNK)
    with pytest.raises(ValueError, match="CUDA"):
        smod.segment_mm_cuda(x, rp, col, cs, lr, CHUNK)
    assert smod.segment_mm_cuda.launches == before
    assert smod.load_library.cache_info().currsize == 0

"""The port's CIN layer (``repro_torch/kernels/cin``) against the JAX
package's: the plain versions ``cin_layer_ref`` and ``cin_ref`` (through
``ops.cin_layer`` / ``ops.cin`` on CPU tensors) against the reference's
``cin_layer(..., impl="ref")`` and its Pallas kernel in interpret mode
(``impl="interpret"``), over the case table of ``kernels/cin/cases.py``
(which the card's checks share: B = 1, 7, 25, 37 and 512, m = 6 and 39,
H = 6 to 200, H2 = 16 and 200, D = 8 and 10); the float32 rule the card
holds the kernel to, which must reject a planted fault; the dispatch of
``ops.cin_layer``; and the CUDA wrapper's refusals, which come before
anything is built. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: the rule of ``cases.py``, ``|o - r| <= 2^-16 A`` with ``A`` the
same layer on absolute values (for the pooled features of a stack, the
stack on absolute values). Both sides sum the same float32 products in
another order, which moves an element by a few ``2^-24 A``; measured here,
the rule reads at most about 0.03 on sound outputs and above 600 on the
planted fault.
"""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.cin.ops import cin as ref_cin  # noqa: E402
from repro.kernels.cin.ops import cin_layer as ref_cin_layer  # noqa: E402
from repro_torch.kernels.cin import kernel as cmod  # noqa: E402
from repro_torch.kernels.cin.cases import (CASES, FAULT_CASE,  # noqa: E402
                                           GRAD_CASES, case_inputs,
                                           emulated_layer, grad_case_inputs,
                                           excess, layer_excess,
                                           planted_fault, pooled_magnitude,
                                           tf32_round)
from repro_torch.kernels.cin.ops import cin, cin_layer  # noqa: E402
from repro_torch.kernels.cin.ref import cin_layer_ref, cin_ref  # noqa: E402


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, impl):
    x0, xk, w = case_inputs(CASES[name])
    tx0, txk, tw = _torch(x0, xk, w)
    got = cin_layer(tx0, txk, tw)
    want = torch.from_numpy(np.asarray(ref_cin_layer(
        jnp.asarray(x0), jnp.asarray(xk), jnp.asarray(w), impl=impl)))
    assert got.shape == want.shape == (x0.shape[0], w.shape[0], x0.shape[2])
    assert layer_excess(got, want, tx0, txk, tw) <= 1.0


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("widths", [(200, 200, 200), (16, 16)])
def test_stack_matches_jax(widths, impl):
    """``cin()``'s pooled features over a stack at xdeepfm's CIN widths
    (m = 39, D = 10) and at the smoke config's (m = 6, D = 8)."""
    m, D = (39, 10) if widths[0] == 200 else (6, 8)
    r = np.random.default_rng(len(widths))
    x0 = (r.standard_normal((9, m, D)) * 0.01).astype(np.float32)
    ws, prev = [], m
    for hk in widths:
        ws.append((r.standard_normal((hk, prev, m))
                   * (prev * m) ** -0.5).astype(np.float32))
        prev = hk
    tx0, tws = torch.from_numpy(x0), _torch(*ws)
    got = cin(tx0, tws)
    torch.testing.assert_close(got, cin_ref(tx0, tws), rtol=0, atol=0)
    want = torch.from_numpy(np.asarray(ref_cin(
        jnp.asarray(x0), [jnp.asarray(w) for w in ws], impl=impl)))
    assert got.shape == want.shape == (9, sum(widths))
    assert excess(got, want, pooled_magnitude(tx0, tws)) <= 1.0


def test_rule_rejects_a_dropped_h_slice():
    """At the full-width layer (B = 512, H = 200): the plain version in
    float64 (another sound computation) reads far below 1; the plain layer
    with one h slice of W dropped, at the first, middle or last h, reads
    far above it; the fault leaves W itself unchanged."""
    tx0, txk, tw = _torch(*case_inputs(FAULT_CASE))
    ref = cin_layer_ref(tx0, txk, tw)
    f64 = cin_layer_ref(tx0.double(), txk.double(), tw.double()).float()
    assert layer_excess(f64, ref, tx0, txk, tw) < 0.1
    w_before = tw.clone()
    for h in (0, FAULT_CASE[2] // 2, FAULT_CASE[2] - 1):
        bad = planted_fault(tx0, txk, tw, h=h)
        assert layer_excess(bad, ref, tx0, txk, tw) > 100.0
    assert torch.equal(tw, w_before)
    # chunking the allowance changes nothing
    assert layer_excess(bad, ref, tx0, txk, tw, chunk=100) == layer_excess(
        bad, ref, tx0, txk, tw)


def test_tf32_round_keeps_ten_mantissa_bits_ties_away():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: 10 explicit mantissa bits,
    to nearest, ties away from zero, for either sign."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, 1.5,
                      -(1 + ulp / 2), 2.0 ** -130, 0.0], dtype=torch.float32)
    want = [1.0, 1 + ulp, 1.0, 1 + ulp, 1.5, -(1 + ulp), 2.0 ** -130, 0.0]
    assert tf32_round(x).tolist() == want
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(
        1000).astype(np.float32))
    t = tf32_round(r)
    assert torch.equal(t.view(torch.int32) & 0x1FFF,
                       torch.zeros(1000, dtype=torch.int32))
    assert float(((t - r).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_emulation_within_a_tenth_of_the_rule(name):
    """The kernel's arithmetic (3xTF32: hi hi + hi lo + lo hi, each operand
    split into TF32 hi and lo) emulated in plain PyTorch reads at most 0.1
    of the float32 rule against the plain layer on every case; one TF32
    pass is not held to anything here (``chip_smoke.py`` reports it)."""
    tx0, txk, tw = _torch(*case_inputs(CASES[name]))
    ref = cin_layer_ref(tx0, txk, tw)
    got = emulated_layer(tx0, txk, tw)
    assert got.shape == ref.shape
    assert layer_excess(got, ref, tx0, txk, tw) <= 0.1
    with pytest.raises(ValueError, match="passes"):
        emulated_layer(tx0, txk, tw, passes=2)


def test_excess_counts_zero_allowance():
    z = torch.zeros(2, 3)
    assert excess(z, z, z) == 0.0
    assert excess(z + 1e-30, z, z) == float("inf")


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    tx0, txk, tw = _torch(*case_inputs(CASES["smoke-layer2-B512"]))
    before = cmod.cin_layer_cuda.launches
    out = cin_layer(tx0, txk, tw)
    assert cmod.cin_layer_cuda.launches == before
    torch.testing.assert_close(out, cin_layer_ref(tx0, txk, tw), rtol=0,
                               atol=0)
    torch.testing.assert_close(cin_layer(tx0, txk, tw, impl="ref"), out,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        cin_layer(tx0, txk, tw, impl="interpret")
    with pytest.raises(ValueError, match="impl"):
        cin(tx0, [tw], impl="pallas")


def test_cuda_wrapper_refuses_before_building():
    """bf16, a shape that does not agree, an unsupported width, a strided
    view and CPU tensors are all refused by the checks, so the library is
    never built or loaded here."""
    tx0, txk, tw = _torch(*case_inputs(CASES["xdeepfm-layer1-B7"]))
    before = cmod.cin_layer_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        cmod.cin_layer_cuda(tx0.bfloat16(), txk.bfloat16(), tw.bfloat16())
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_layer_cuda(tx0, txk[:, :5], tw)
    with pytest.raises(ValueError, match="3-d"):
        cmod.cin_layer_cuda(tx0[0], txk, tw)
    wide = torch.zeros(7, 39, 129)
    with pytest.raises(ValueError, match="D <="):
        cmod.cin_layer_cuda(wide, wide, torch.zeros(4, 39, 39))
    with pytest.raises(ValueError, match="contiguous"):
        cmod.cin_layer_cuda(tx0.transpose(0, 1).contiguous().transpose(0, 1),
                            txk, tw)
    with pytest.raises(ValueError, match="CUDA"):
        cmod.cin_layer_cuda(tx0, txk, tw)
    assert cmod.cin_layer_cuda.launches == before
    assert cmod.load_library.cache_info().currsize == 0


def test_gradient_wrappers_refuse_before_building():
    """The gradient wrappers' checks (shapes that do not agree, float64,
    a strided view, fields the dx kernel does not take, CPU tensors) come
    before the library is built or loaded, and a refused call counts no
    launch."""
    x0, xk, w, dy = _torch(*grad_case_inputs(
        GRAD_CASES["xdeepfm-layer2-B37"]))
    counts = (cmod.cin_dx_cuda, cmod.cin_dw_cuda)
    before = [c.launches for c in counts]
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_dx_cuda(x0, xk, dy[:, :5], w)
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_dx_cuda(x0, xk, dy, w[:, :7])
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_dw_cuda(x0, xk[:3], dy)
    with pytest.raises(ValueError, match="3-d"):
        cmod.cin_dw_cuda(x0[0], xk, dy)
    with pytest.raises(ValueError, match="float32"):
        cmod.cin_dw_cuda(x0.double(), xk.double(), dy.double())
    with pytest.raises(ValueError, match="contiguous"):
        cmod.cin_dx_cuda(x0, xk, dy.transpose(1, 2).contiguous().transpose(
            1, 2), w)
    with pytest.raises(ValueError, match="CUDA"):
        cmod.cin_dw_cuda(x0, xk, dy)
    with pytest.raises(ValueError, match="CUDA"):
        cmod.cin_dx_cuda(x0, xk, dy, w)
    assert [c.launches for c in counts] == before
    assert cmod.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("m", [9, 16, 20, 32, 41, 64])
def test_dx_wrapper_refuses_fields_it_does_not_take(m):
    """The dx kernel takes fields padded to 8 or 40 and H2 up to 224 (every
    shape xDeepFM and the case table use); ``dx_check`` refuses other
    shapes, and the wrapper refuses them (here first for the CPU tensors)
    before anything is built."""
    x0 = torch.zeros(3, m, 10)
    xk = torch.zeros(3, 16, 10)
    dy = torch.zeros(3, 16, 10)
    w = torch.zeros(16, 16, m)
    before = cmod.cin_dx_cuda.launches
    with pytest.raises(ValueError, match="m padded to 8 or 40"):
        cmod.dx_check(m, 16)
    with pytest.raises(ValueError, match="CUDA|m padded"):
        cmod.cin_dx_cuda(x0, xk, dy, w)
    with pytest.raises(ValueError, match="H2 <= 224"):
        cmod.dx_check(39, 225)
    assert cmod.dx_check(39, 224) == 40
    assert cmod.cin_dx_cuda.launches == before
    assert cmod.load_library.cache_info().currsize == 0


def test_dw_plan():
    """dW's K parts fill the SMs at the training batch's layers (2 and 10
    on an H100's 132: 126 and 130 blocks) and at most one a stage; a warp's
    16 rows are 8 fields of two filters, so layer 1's 39 filters make 20
    pairs; the tile and stage constants match the source's."""
    p2 = cmod.dw_plan(65536, 39, 200, 200, 10, 132)
    assert (p2["ni"], p2["nt"], p2["mp"], p2["groups"], p2["tiles"],
            p2["T"], p2["parts"]) == (200, 1, 40, 500, 63, 40960, 2)
    assert p2["split_floats"] == 262_144_000     # 1.05 GB: dy's hi and lo
    assert p2["part_floats"] == 2 * 200 * 200 * 39
    p1 = cmod.dw_plan(65536, 39, 39, 200, 10, 132)
    assert (p1["groups"], p1["tiles"], p1["parts"]) == (100, 13, 10)
    assert cmod.dw_plan(7, 6, 6, 16, 8, 132)["parts"] == 4    # T = 4
    assert cmod.dw_plan(1, 39, 200, 200, 10, 132)["parts"] == 1
    assert cmod.dw_plan(65536, 6, 16, 16, 8, 132)["parts"] == 132
    assert cmod.dw_plan(65536, 6, 16, 16, 8, 132)["part_floats"] == \
        132 * 16 * 16 * 6
    big = cmod.dw_plan(512, 39, 200, 300, 10, 132)
    assert (big["ni"], big["nt"], big["parts"]) == (200, 2, 1)
    src = cmod._build.source_paths(cmod.SOURCES)[0].read_text()
    assert f"constexpr int kBM = {cmod.BM};" in src
    assert f"constexpr int kKS = {cmod.STAGE_K // 8};" in src
    assert "return H2 <= 16 ? 16 : (H2 <= 64 ? 64 : 200);" in src
    assert cmod.N_TILES == (16, 64, 200)


def test_dx_plan():
    """The dx kernel's N tiles are whole filters (5 of 40 fields at m 39;
    at 8 fields the width of 16, 64 and 200 that pads H * 8 least), its
    K = H2 padded to stages of 16, and its N parts fill the SMs where the
    M tiles are fewer (one at the training batch)."""
    p = cmod.dx_plan(65536, 39, 200, 200, 10, 132)
    assert (p["ni"], p["mp"], p["ntn"], p["T"], p["parts"], p["tiles"]) == (
        200, 40, 40, 13, 1, 5120)
    assert p["split_floats"] == 40 * 13 * 6400 and p["part_floats"] == 0
    assert cmod.dx_plan(65536, 39, 39, 200, 10, 132)["ntn"] == 8
    assert cmod.dx_plan(512, 39, 200, 200, 10, 132)["parts"] == 3
    assert cmod.dx_plan(1, 39, 200, 200, 10, 132)["parts"] == 40
    assert cmod.dx_plan(7, 6, 6, 16, 8, 132)["ni"] == 16       # 48 columns
    assert cmod.dx_plan(9, 6, 16, 6, 8, 132)["ni"] == 64       # 128: a tie
    assert cmod.dx_plan(9, 6, 200, 6, 8, 132)["ni"] == 200     # 1,600
    assert cmod.dx_plan(9, 6, 39, 6, 8, 132)["ni"] == 64       # 320
    assert cmod.dx_plan(61, 39, 200, 39, 10, 132)["T"] == 3
    assert cmod.dx_check(1, 6) == 8 and cmod.dx_check(33, 200) == 40
    src = cmod._build.source_paths(cmod.SOURCES)[0].read_text()
    for ni, mp in ((200, 40), (200, 8), (64, 8), (16, 8)):
        assert f"launch_dx<{ni}, {mp}>" in src
    # the largest K = H2 whose staged dy rows fit beside the 4-stage ring
    # in an H100's 232,448 bytes at N tile 200 (cin.cu's dx_smem)
    pitch = 32 * ((-(-cmod.DX_MAX_H2 // 16) + 1) // 2) + 4
    assert 128 + 4 * 6400 * 4 + 4 * 128 * pitch + 64 <= 232_448
    pitch = 32 * ((-(-(cmod.DX_MAX_H2 + 1) // 16) + 1) // 2) + 4
    assert 128 + 4 * 6400 * 4 + 4 * 128 * pitch + 64 > 232_448
    assert "constexpr int kDxStages = 4;" in src
    cand = ", ".join(map(str, reversed(cmod.N_TILES)))
    assert f"const int cand[3] = {{{cand}}};" in src

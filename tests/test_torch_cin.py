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

from repro.kernels.cin.ops import cin as ref_cin  # noqa: E402
from repro.kernels.cin.ops import cin_layer as ref_cin_layer  # noqa: E402
from repro_torch.kernels.cin import kernel as cmod  # noqa: E402
from repro_torch.kernels.cin.cases import (CASES, FAULT_CASE,  # noqa: E402
                                           case_inputs, excess,
                                           layer_excess, planted_fault,
                                           pooled_magnitude)
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

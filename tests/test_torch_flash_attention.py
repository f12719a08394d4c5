"""The port's attention (``repro_torch/kernels/flash_attention``) against
the JAX package's: the plain version ``attention_ref`` against the
reference's ``attention_ref`` and against its Pallas kernel in interpret
mode, over GQA groups 1 and 2, causal on and off, window 0 and 16, softcap
0 and 50, ``kv_len < Skv`` (scalar and per batch row), ``q_offset > 0``,
ragged lengths and fully masked rows (the case table of
``kernels/flash_attention/cases.py``, which the card's checks share); the
bf16 rule the card holds the kernel to, which must pass another sound
computation and reject a planted fault; the dispatch of ``ops.attention``;
and the CUDA wrapper's refusal of CPU tensors. The CUDA kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance, float32: 2e-5 absolute and relative. Both sides sum the same
float32 products in another order, and the Pallas kernel scales q before
the q.k product where the plain versions scale the score after it."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ops import attention as ref_attention  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.cases import (CASES,  # noqa: E402
                                                       bf16_excess,
                                                       case_kwargs,
                                                       planted_fault)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
# Pallas interpret mode steps through its grid in Python: the cases beyond
# this many (q, k) score entries (gemma2's widths) are held to the JAX ref
# only
INTERPRET_MAX_SCORES = 2 ** 20


def _inputs(case, dtype=np.float32):
    B, Hq, Hkv, Sq, Skv, D, *_, q_scale = case
    r = np.random.default_rng(Sq * 1000 + Skv + D)
    q = (r.standard_normal((B, Hq, Sq, D)) * q_scale).astype(dtype)
    k = r.standard_normal((B, Hkv, Skv, D)).astype(dtype)
    v = r.standard_normal((B, Hkv, Skv, D)).astype(dtype)
    return q, k, v


def _port(q, k, v, kw):
    return attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_ref_and_pallas_interpret(name):
    case = CASES[name]
    B, Hq, _, Sq, Skv, *_ = case
    q, k, v = _inputs(case)
    kw = case_kwargs(case)
    got = _port(q, k, v, kw)
    jkw = {**kw}
    for key in ("kv_len", "q_offset"):
        if jkw[key] is not None:
            jkw[key] = jnp.asarray(np.asarray(jkw[key], np.int32))
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **jkw))
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the reference's Pallas kernel takes a scalar kv_len only
    if jkw["kv_len"] is None or jkw["kv_len"].ndim == 0:
        if B * Hq * Sq * Skv <= INTERPRET_MAX_SCORES:
            pallas = np.asarray(ref_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                impl="interpret", bq=16, bk=32, **jkw))
            np.testing.assert_allclose(got, pallas, **F32_TOL)
    assert np.isfinite(got).all()


def test_fully_masked_rows_are_zero():
    case = CASES["fully-masked-rows"]
    got = _port(*_inputs(case), case_kwargs(case))
    # q positions 60 .. 67 with window 4 see keys 57 .. 67, all >= kv_len 40
    assert (got == 0).all()
    case = CASES["no-valid-key"]
    assert (_port(*_inputs(case), case_kwargs(case)) == 0).all()


def test_per_row_kv_len_matches_jax_ref():
    """``kv_len`` of shape ``[B]`` (the reference's plain version takes it;
    its Pallas kernel takes a scalar only); the row with kv_len 0 is zero."""
    case = CASES["kv_len-per-row"]
    q, k, v = _inputs(case)
    kv_len = np.array(case[9], np.int32)
    got = _port(q, k, v, case_kwargs(case))
    want = np.asarray(jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{**case_kwargs(case), "kv_len": jnp.asarray(kv_len),
           "q_offset": jnp.int32(case[10])}))
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (got[kv_len == 0] == 0).all()


def test_bf16_plain_matches_jax_ref():
    """bf16 inputs: both plain versions compute in float32 from the same
    bf16 values and round the output to bf16, so they agree within one bf16
    ulp of the output (|o| < 4 here: 2^-6)."""
    case = CASES["window16-softcap50"]
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(case))
    got = attention_ref(q, k, v, **case_kwargs(case)).float().numpy()
    as_jnp = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in (q, k, v)]
    want = np.asarray(jax_attention_ref(*as_jnp, **case_kwargs(case)).astype(
        jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6)


# a small windowed, softcapped layer for the bf16 rule: B, Hq, Hkv, S, D
RULE_SHAPE = (1, 4, 2, 512, 64)
RULE_KW = dict(causal=True, window=128, softcap=50.0)


def _rule_inputs():
    B, Hq, Hkv, S, D = RULE_SHAPE
    r = np.random.default_rng(7)
    return [torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16) for shape in ((B, Hq, S, D), (B, Hkv, S, D),
                                      (B, Hkv, S, D))]


def test_bf16_rule_accepts_another_sound_computation():
    """The reference's plain version in bf16 (another framework, another
    summation order, its own rounding to bf16) is within the rule the card
    holds the kernel to; so are zero rows that are exactly zero."""
    q, k, v = _rule_inputs()
    got = attention_ref(q, k, v, **RULE_KW)
    want = torch.from_numpy(np.array(jax_attention_ref(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), **RULE_KW).astype(jnp.float32)))
    assert bf16_excess(got, want) <= 1.0
    case = CASES["no-valid-key"]
    zq, zk, zv = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(case))
    zero = attention_ref(zq, zk, zv, **case_kwargs(case))
    assert bf16_excess(zero, zero) == 0.0
    assert bf16_excess(zero + 2.0 ** -20, zero) == float("inf")


def test_bf16_rule_rejects_a_dropped_kv_tile():
    """A kernel that skips the first kv tile its window's edge cuts, on the
    query tiles of the second half (the tensor-core kernel's tiles: 128
    query rows, 64 keys), fails the rule; before that row it is the plain
    version's."""
    q, k, v = _rule_inputs()
    ref = attention_ref(q, k, v, **RULE_KW)
    bad = planted_fault(q, k, v, from_row=256, window=RULE_KW["window"],
                        softcap=RULE_KW["softcap"])
    assert torch.equal(bad[:, :, :256], ref[:, :, :256])
    assert bf16_excess(bad, ref) > 4.0
    assert torch.equal(planted_fault(q, k, v, from_row=512, window=128,
                                     softcap=50.0), ref)


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    case = CASES["kv_len-chunk"]
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    before = flash_attention_cuda.launches
    kw = case_kwargs(case)
    out = attention(q, k, v, **kw)
    assert flash_attention_cuda.launches == before
    torch.testing.assert_close(out, attention_ref(q, k, v, **kw), rtol=0,
                               atol=0)
    torch.testing.assert_close(attention(q, k, v, impl="ref", **kw), out,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        attention(q, k, v, impl="pallas")


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES["gqa2-causal"]))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == before

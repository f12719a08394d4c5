"""The port's differentiable attention (``kernels/flash_attention/
blocked.py``: ``attention_mef``, its ``mef_forward`` / ``mef_backward``,
and ``attention_blocked``) against the JAX package's
(``kernels/flash_attention/ops.py``: ``jax.vjp`` of ``attention_mef``, its
``_mef_fwd_pass``'s lse, and ``jax.grad`` of ``impl="blocked_ad"``, as
its own ``tests/test_kernels.py`` checks them), over the cases of
``kernels/flash_attention/cases.py``'s ``GRAD_CASES`` at head dim 16 and
kv blocks of 32 (so Skv is padded and several blocks run), in float64 on
both sides; also the backward's bf16 rule and planted faults, the CPU
dispatch of ``ops.attention`` under autograd, and the backward wrapper's
refusals.

The reference casts q, k and v to float32 inside its attention
(``ops.py:158, 242``), so under ``jax.enable_x64`` it would still compute
in float32. Here it runs with ``jnp.float32`` read as ``jnp.float64`` in
its module (``reference_in_float64``): the same arithmetic, carried out in
float64 as the port's plain version carries it out for float64 inputs.
The reference's mask takes a scalar ``kv_len``; a case with one per
batch row runs the reference row by row.

Tolerance: 1e-9 of the reference's largest magnitude (float64 sums in
other orders differ by about 1e-14).
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)


import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro_torch.kernels.flash_attention import blocked, cases  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bwd_cuda, tma_ready)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from torch_testing import reference_in_float64  # noqa: E402

D_CPU, BK = 16, 32
TOL = 1e-9


def _inputs(case, seed=0):
    B, Hq, Hkv, Sq, Skv, _, *_, qs = case
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, Sq, D_CPU)) * qs
    k = r.standard_normal((B, Hkv, Skv, D_CPU))
    v = r.standard_normal((B, Hkv, Skv, D_CPU))
    do = r.standard_normal((B, Hq, Sq, D_CPU))
    return q, k, v, do


def _reference(case, q, k, v, do):
    """The reference's (o, lse, mef grads, blocked_ad grads), row by row
    where kv_len is per row."""
    kw = cases.case_kwargs(case)
    kv_len, q_offset = kw.pop("kv_len"), kw.pop("q_offset")
    B = q.shape[0]
    rows = ([(slice(b, b + 1), int(kv_len[b])) for b in range(B)]
            if isinstance(kv_len, torch.Tensor) else [(slice(0, B), kv_len)])
    out = {n: [] for n in ("o", "lse", "mef", "ad")}
    run_jit = None
    with reference_in_float64(ref_ops):
        for sl, kvl in rows:
            args = [jnp.asarray(x[sl]) for x in (q, k, v)]
            g = jnp.asarray(do[sl])

            def run(q_, k_, v_, g_, kvl_j, qo_j):
                def mef(q_, k_, v_):
                    return ref_ops.attention_mef(q_, k_, v_, kv_len=kvl_j,
                                                 q_offset=qo_j, bk=BK, **kw)

                def ad(q_, k_, v_, g_):
                    return jnp.sum(ref_ops.attention_blocked.__wrapped__(
                        q_, k_, v_, kv_len=kvl_j, q_offset=qo_j, bq=BK,
                        bk=BK, **kw) * g_)

                o, vjp = jax.vjp(mef, q_, k_, v_)
                # the forward pass's lse: q pre-scaled, Skv padded to BK
                Bs, Hq, Sq, D = q_.shape
                Hkv, Skv = k_.shape[1], k_.shape[2]
                pad = (-Skv) % min(BK, Skv)
                kp, vp = (jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))
                          for x in (k_, v_))
                qs = (q_ * D ** -0.5).reshape(Bs, Hkv, Hq // Hkv, Sq, D)
                _, lse = ref_ops._mef_fwd_pass(
                    qs, kp, vp, kvl_j, qo_j, kw["causal"], kw["window"],
                    kw["softcap"], D ** -0.5, min(BK, Skv))
                return (o, lse.reshape(Bs, Hq, Sq), vjp(g_),
                        jax.grad(ad, argnums=(0, 1, 2))(q_, k_, v_, g_))

            run_jit = run_jit or jax.jit(run)   # one trace for every row

            o, lse, g_mef, g_ad = run_jit(
                *args, g, jnp.int32(k.shape[2] if kvl is None else kvl),
                jnp.int32(q_offset or 0))
            out["o"].append(np.asarray(o))
            out["lse"].append(np.asarray(lse))
            out["mef"].append([np.asarray(x) for x in g_mef])
            out["ad"].append([np.asarray(x) for x in g_ad])
    return {"o": np.concatenate(out["o"]),
            "lse": np.concatenate(out["lse"]),
            "mef": [np.concatenate(x) for x in zip(*out["mef"])],
            "ad": [np.concatenate(x) for x in zip(*out["ad"])]}


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name", list(cases.GRAD_CASES))
def test_mef_matches_reference_vjp_and_blocked_ad(name):
    case = cases.GRAD_CASES[name]
    q, k, v, do = _inputs(case)
    want = _reference(case, q, k, v, do)
    kw = cases.case_kwargs(case)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = blocked.attention_mef(*t, bk=BK, **kw)
    o.backward(torch.from_numpy(do))
    _close(o, want["o"])
    for got, a, b in zip(t, want["mef"], want["ad"]):
        _close(got.grad, a)
        _close(got.grad, b)
    _, lse = blocked.mef_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                 bk=BK, **kw)
    _close(lse, want["lse"])
    # the port's blocked_ad (autograd through its loop) gives the same
    t2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    blocked.attention_blocked(*t2, bq=BK, bk=BK, **kw).backward(
        torch.from_numpy(do))
    for got, b in zip(t2, want["ad"]):
        _close(got.grad, b)


@pytest.mark.parametrize("name", list(cases.GRAD_CASES))
def test_backward_rule_accepts_sound_float32_and_rejects_faults(name):
    """A float32 backward (``mef_backward``) and the kernels' emulation
    (``emulated_backward``: their rounding points in their tile order at
    the case's head dim) on bf16 inputs, o and lse read under the rule;
    both planted faults (in the same tiles) read above it, and every fully
    masked element is exactly zero."""
    case = cases.GRAD_CASES[name]
    D = case[5]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(case, seed=1))
    kw = cases.case_kwargs(case)
    o, lse = blocked.mef_forward(q, k, v, **kw)
    o = o.to(torch.bfloat16)
    ref = cases.grad_reference(q, k, v, o, lse, do, chunk=40, **kw)
    sound = blocked.mef_backward(q, k, v, o, lse, do, **kw)
    emulated = cases.emulated_backward(q, k, v, o, lse.float(), do,
                                       tiles_of=D, **kw)
    for n, g, e in zip(("dq", "dk", "dv"), sound, emulated):
        assert cases.grad_excess(g.to(torch.bfloat16), ref[n],
                                 ref["a_" + n]) <= 1.0, n
        assert cases.grad_excess(e, ref[n], ref["a_" + n]) <= 1.0, n
    for fault in cases.GRAD_FAULTS:
        bad = cases.grad_reference(q, k, v, o, lse, do, drop=fault,
                                   tiles_of=D, **kw)
        assert max(cases.grad_excess(bad[n], ref[n], ref["a_" + n])
                   for n in ("dq", "dk", "dv")) > 1.0, fault
    if isinstance(kw["kv_len"], torch.Tensor):   # batch row 2 sees no key
        for n in ("dq", "dk", "dv"):
            assert float(ref[n][2].abs().max()) == 0.0


def test_dropped_pairs_follow_the_kernels_loops():
    """The dK/dV fault drops, per key block (128 keys at D 128, 64 at D
    256), the pairs of the first 64-row query tile it visits; the dQ fault,
    per query block (128 or 64 rows), those of the first kv tile of 64."""
    mask = cases.pair_mask(1, 200, 200, causal=True, window=0)
    gone = cases.dropped_pairs(mask, "dkdv", 128)
    assert bool(gone[0, 128:192, 128:].equal(mask[0, 128:192, 128:]))
    assert not bool(gone[0, 192:, 128:].any())
    gone = cases.dropped_pairs(mask, "dkdv", 256)
    assert bool(gone[0, 64:128, 64:128].equal(mask[0, 64:128, 64:128]))
    assert not bool(gone[0, 128:, 64:128].any())
    gone = cases.dropped_pairs(mask, "dq", 128)
    assert bool(gone[0, 128:, :64].equal(mask[0, 128:, :64]))
    assert not bool(gone[0, 128:, 64:].any())
    gone = cases.dropped_pairs(mask, "dq", 256)
    assert bool(gone[0, 64:128, :64].equal(mask[0, 64:128, :64]))
    assert not bool(gone[0, 64:128, 64:].any())


def _timed_shape(name):
    """(B, Hq, Hkv, S, S, D, causal, window, ...) of a timed shape: the
    training cell's length at gemma2-9b's global and local layers and at
    mistral-nemo-12b's."""
    arch, layer = name.split(":")
    c = get_arch(arch)
    window = c.sliding_window if layer == "local" else 0
    return (1, c.n_heads, c.n_kv_heads, 4096, 4096, c.head_dim, True,
            window, c.attn_logit_softcap, None, None, 1.0)


@pytest.mark.parametrize("name", list(cases.GRAD_CASES) + [
    "gemma2-9b:global", "gemma2-9b:local", "mistral-nemo-12b:global"])
def test_backward_loops_visit_each_unmasked_pair_once(name):
    """Each launch's loops (``cases.bwd_loops``, the kernels' own ranges)
    visit every tile that holds an unmasked pair exactly once, for every
    query head of a group, and no tile twice."""
    case = (cases.GRAD_CASES[name] if name in cases.GRAD_CASES
            else _timed_shape(name))
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    kw = cases.case_kwargs(case)
    G, r, outer = Hq // Hkv, kernel.BWD_STAGE_ROWS, kernel.BWD_BLOCK_ROWS[D]
    mask = cases.pair_mask(B, Sq, Skv, kw["kv_len"], kw["q_offset"],
                           kw["causal"], kw["window"])
    kvls = (kw["kv_len"].tolist() if isinstance(kw["kv_len"], torch.Tensor)
            else [Skv if kw["kv_len"] is None else kw["kv_len"]] * B)

    def live(m, rows, cols):
        """bool [ceil(Sq / rows), ceil(Skv / cols)]: tiles with a pair."""
        pad = torch.zeros((-(-Sq // rows) * rows, -(-Skv // cols) * cols),
                          dtype=torch.bool)
        pad[:Sq, :Skv] = m
        return pad.reshape(pad.shape[0] // rows, rows, -1, cols).any(3).any(1)

    for b, kvl in enumerate(kvls):
        m = mask[b if mask.shape[0] > 1 else 0]
        loops = cases.bwd_loops(Sq, Skv, D, min(max(kvl, 0), Skv),
                                kw["q_offset"], kw["causal"], kw["window"], G)
        seen = torch.zeros((G, -(-Sq // r), -(-Skv // outer)),
                           dtype=torch.int32)
        for k0, its in loops["dkdv"]:
            for g, q0 in its:
                seen[g, q0 // r, k0 // outer] += 1
        want = live(m, r, outer)
        assert bool((seen[:, want] == 1).all()) and int(seen.max()) <= 1
        seen = torch.zeros((-(-Sq // outer), -(-Skv // r)), dtype=torch.int32)
        for q0, kts in loops["dq"]:
            for k0 in kts:
                seen[q0 // outer, k0 // r] += 1
        want = live(m, outer, r)
        assert bool((seen[want] == 1).all()) and int(seen.max()) <= 1


def test_ops_runs_the_plain_mef_under_autograd_on_the_cpu():
    """CPU tensors that require grad go through ``attention_mef`` (its
    gradients, bit for bit); without autograd through ``attention_ref``;
    the reference's impl names run their plain versions."""
    case = cases.GRAD_CASES["window40-softcap50-d128"]
    q, k, v, do = (torch.from_numpy(x).float() for x in _inputs(case))
    kw = cases.case_kwargs(case)
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.attention(*t, **kw).backward(do)
    t2 = [x.clone().requires_grad_() for x in (q, k, v)]
    blocked.attention_mef(*t2, **kw).backward(do)
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(t, t2))
    with torch.no_grad():
        assert torch.equal(ops.attention(q, k, v, **kw),
                           attention_ref(q, k, v, **kw))
    ref = attention_ref(q, k, v, **kw)
    for impl in ("blocked", "blocked_ad"):
        torch.testing.assert_close(ops.attention(q, k, v, impl=impl, **kw),
                                   ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        ops.attention(q, k, v, impl="pallas")


def test_backward_wrapper_refuses_what_it_does_not_take():
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    q, k = t(1, 2, 8, 128), t(1, 1, 8, 128)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd_cuda(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="head dim must be one of"):
        flash_attention_bwd_cuda(t(1, 2, 8, 64), t(1, 1, 8, 64),
                                 t(1, 1, 8, 64), t(1, 2, 8, 64), lse,
                                 t(1, 2, 8, 64))
    with pytest.raises(ValueError, match="takes bfloat16"):
        f = t(1, 2, 8, 128, dtype=torch.float32)
        flash_attention_bwd_cuda(f, f[:, :1], f[:, :1], f, lse, f)


def test_tma_ready_is_the_one_operand_rule():
    """The rule both wrappers check operands by and ``FlashAttention``
    copies an incoming gradient by: unit last stride, a 16-byte aligned
    base, strides of whole 16-byte rows (a dim of one is free)."""
    x = torch.zeros((2, 4, 16, 128), dtype=torch.bfloat16)
    assert tma_ready(x)
    assert tma_ready(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert tma_ready(x[:, :, 3:])                   # 3 rows of 256 bytes in
    assert not tma_ready(x.transpose(2, 3))         # last stride 16
    assert not tma_ready(x.reshape(-1)[1:1 + 2 * 4 * 15 * 128]
                         .view(2, 4, 15, 128))      # base 2 bytes in
    y = torch.zeros((1, 1, 5, 132), dtype=torch.bfloat16)[..., :128]
    assert not tma_ready(y)                         # row stride 132
    assert tma_ready(y[:, :, :1])                   # a single row is free


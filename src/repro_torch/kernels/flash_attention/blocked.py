"""Plain PyTorch versions of the reference's differentiable attention paths
(``src/repro/kernels/flash_attention/ops.py``):

  * ``attention_blocked`` (``ops.py:52-131``): the online softmax over kv
    blocks, differentiated by autograd through its loop: the reference's
    ``impl="blocked_ad"``, the oracle of the gradient tests;
  * ``mef_forward`` / ``mef_backward`` (``ops.py:153-218``): the
    FlashAttention-2 forward with its log-sum-exp and the blocked backward
    that recomputes each kv block from ``(q, k, v, o, lse)``;
  * ``attention_mef`` (``ops.py:221-265``): the two as one autograd
    function, the reference's ``impl="blocked"`` (its training path). Its
    backward keeps ``q``, ``k``, ``v``, ``o`` and ``lse``, never a score
    tile.

They are the CPU path of ``ops.attention`` under autograd and the plain
versions that ``chip_smoke.py`` holds the kernels to. Every quantity is
computed in ``promote_types(dtype, float32)``: float32 for bf16 and
float32 inputs (the reference's casts), float64 for float64 inputs, so the
CPU tests can compare in float64. As in the reference, ``q`` is scaled
before the products, Skv is padded to a multiple of ``bk`` (the padding
masked by ``kv_len``), a row with no valid key gives zeros (and
``lse = -1e30``), and the softcap's chain rule uses the capped score.
``kv_len`` may be ``[]`` or ``[B]`` (the reference's ``_mask_block`` takes
a scalar).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.common import next_multiple
from repro_torch.kernels.flash_attention.ref import NEG_INF, IntLike


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _positions(x: IntLike, default: int, dev: torch.device) -> torch.Tensor:
    """``x`` as an int32 tensor of shape ``[B', 1, 1, 1, 1]`` (B' 1 or B)
    for the masks' broadcast."""
    x = default if x is None else x
    return torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(
        -1, 1, 1, 1, 1)


def _mask(q_pos, k_pos, kv_len, causal: bool, window: int) -> torch.Tensor:
    """The reference's ``_mask_block``: q_pos ``[B', 1, 1, Sq, 1]``, k_pos
    ``[bk]``, kv_len ``[B', 1, 1, 1, 1]`` -> bool ``[B', 1, 1, Sq, bk]``."""
    m = k_pos < kv_len
    if causal:
        m = m & (q_pos >= k_pos)
    if window > 0:
        m = m & ((q_pos - k_pos) < window)
    return m


def _pad_kv(k, v, bk: int):
    pad = (-k.shape[2]) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    return k, v


def _softcap(s, softcap: float):
    return softcap * torch.tanh(s / softcap) if softcap > 0 else s


def mef_forward(q, k, v, kv_len: IntLike = None, q_offset: IntLike = None,
                causal: bool = True, window: int = 0, softcap: float = 0.0,
                scale: Optional[float] = None, bk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward pass of ``_mef_fwd_pass``: ``(o, lse)``, o ``[B, Hq, Sq,
    D]`` and lse ``[B, Hq, Sq]`` in the work dtype (o is not cast back)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    wt = _work_dtype(q.dtype)
    scale = float(scale if scale is not None else D ** -0.5)
    bk = min(bk, Skv)
    dev = q.device
    kvl = _positions(kv_len, Skv, dev)
    q_pos = _positions(q_offset, 0, dev) + torch.arange(
        Sq, dtype=torch.int32, device=dev).reshape(Sq, 1)
    k, v = _pad_kv(k, v, bk)
    qs = q.to(wt).reshape(B, Hkv, G, Sq, D) * scale
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=wt, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=wt, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=wt, device=dev)
    for j in range(k.shape[2] // bk):
        k_j = k[:, :, j * bk:(j + 1) * bk].to(wt)
        v_j = v[:, :, j * bk:(j + 1) * bk].to(wt)
        s = _softcap(torch.einsum("bhgqd,bhkd->bhgqk", qs, k_j), softcap)
        k_pos = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
        msk = _mask(q_pos, k_pos, kvl, causal, window)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    v_j)
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    o = acc / safe[..., None]
    lse = m + torch.log(safe)
    return o.reshape(B, Hq, Sq, D), lse.reshape(B, Hq, Sq)


def mef_backward(q, k, v, o, lse, do, kv_len: IntLike = None,
                 q_offset: IntLike = None, causal: bool = True,
                 window: int = 0, softcap: float = 0.0,
                 scale: Optional[float] = None, bk: int = 512
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_mef_bwd_pass``: ``(dq, dk, dv)`` in the work dtype from the
    forward's ``o`` and ``lse`` and the output's gradient ``do``:
    ``delta = rowsum(do o)``, and per kv block ``P = exp(S - lse)``,
    ``dV = P^T dO``, ``dS = P (dO V^T - delta) (1 - (s/cap)^2)``,
    ``dK = dS^T (scale q)``, ``dQ = dS K scale``."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    wt = _work_dtype(q.dtype)
    scale = float(scale if scale is not None else D ** -0.5)
    bk = min(bk, Skv)
    dev = q.device
    kvl = _positions(kv_len, Skv, dev)
    q_pos = _positions(q_offset, 0, dev) + torch.arange(
        Sq, dtype=torch.int32, device=dev).reshape(Sq, 1)
    k, v = _pad_kv(k, v, bk)
    qs = q.to(wt).reshape(B, Hkv, G, Sq, D) * scale
    o = o.to(wt).reshape(B, Hkv, G, Sq, D)
    do = do.to(wt).reshape(B, Hkv, G, Sq, D)
    lse = lse.to(wt).reshape(B, Hkv, G, Sq)
    delta = torch.sum(do * o, dim=-1)
    dq = torch.zeros_like(qs)
    dks, dvs = [], []
    for j in range(k.shape[2] // bk):
        k_j = k[:, :, j * bk:(j + 1) * bk].to(wt)
        v_j = v[:, :, j * bk:(j + 1) * bk].to(wt)
        s = _softcap(torch.einsum("bhgqd,bhkd->bhgqk", qs, k_j), softcap)
        k_pos = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
        msk = _mask(q_pos, k_pos, kvl, causal, window)
        p = torch.where(msk, torch.exp(s - lse[..., None]), 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, do))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v_j)
        ds = p * (dp - delta[..., None])
        if softcap > 0:
            ds = ds * (1.0 - (s / softcap) ** 2)
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_j)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qs))
    dk = torch.cat(dks, dim=2)[:, :, :Skv]
    dv = torch.cat(dvs, dim=2)[:, :, :Skv]
    return (dq * scale).reshape(B, Hq, Sq, D), dk, dv


class AttentionMef(torch.autograd.Function):
    """``attention_mef``'s custom VJP: the forward keeps ``(q, k, v, o,
    lse)`` and the backward is ``mef_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, causal, window, softcap,
                scale, bk):
        o, lse = mef_forward(q, k, v, kv_len, q_offset, causal, window,
                             softcap, scale, bk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (kv_len, q_offset, causal, window, softcap, scale, bk)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = mef_backward(q, k, v, o, lse, do, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None)


def attention_mef(q, k, v, kv_len: IntLike = None, q_offset: IntLike = None,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None,
                  bk: int = 512) -> torch.Tensor:
    """Grouped (GQA) attention with the flash-style backward; ``[B, Hq, Sq,
    D]`` in q's dtype."""
    return AttentionMef.apply(q, k, v, kv_len, q_offset, causal, window,
                              float(softcap), scale, bk)


def attention_blocked(q, k, v, kv_len: IntLike = None,
                      q_offset: IntLike = None, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      scale: Optional[float] = None, bq: int = 512,
                      bk: int = 512) -> torch.Tensor:
    """The online softmax over kv blocks of ``bk`` keys, query blocks of
    ``bq`` rows (both dimensions padded), differentiated by autograd."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    wt = _work_dtype(q.dtype)
    scale = float(scale if scale is not None else D ** -0.5)
    bq, bk = min(bq, Sq), min(bk, Skv)
    dev = q.device
    Sq_p, Skv_p = next_multiple(Sq, bq), next_multiple(Skv, bk)
    qp = torch.nn.functional.pad(q, (0, 0, 0, Sq_p - Sq))
    kp, vp = _pad_kv(k, v, bk)
    qf = (qp.to(wt) * scale).reshape(B, Hq, Sq_p // bq, bq, D)
    kvl = torch.as_tensor(Skv if kv_len is None else kv_len,
                          dtype=torch.int32, device=dev).reshape(-1, 1, 1, 1,
                                                                 1)
    q_pos = (torch.as_tensor(0 if q_offset is None else q_offset,
                             dtype=torch.int32, device=dev)
             + torch.arange(Sq_p, dtype=torch.int32, device=dev)).reshape(
        Sq_p // bq, bq, 1)
    m = torch.full((B, Hq, Sq_p // bq, bq), NEG_INF, dtype=wt, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hq, Sq_p // bq, bq, D), dtype=wt, device=dev)
    for j in range(Skv_p // bk):
        kk = kp[:, :, j * bk:(j + 1) * bk].to(wt).repeat_interleave(group, 1)
        vv = vp[:, :, j * bk:(j + 1) * bk].to(wt).repeat_interleave(group, 1)
        s = _softcap(torch.einsum("bhnqd,bhkd->bhnqk", qf, kk), softcap)
        k_pos = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
        mask = k_pos < kvl
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhnqk,bhkd->bhnqd", p,
                                                    vv)
        m = m_new
    safe = torch.where(l > 0, l, 1.0)
    out = (acc / safe[..., None]).reshape(B, Hq, Sq_p, D)[:, :, :Sq]
    return out.to(q.dtype)

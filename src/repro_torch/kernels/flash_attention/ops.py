"""Public attention entry point of the transformer models: the port of the
JAX package's ``kernels/flash_attention/ops.py`` ``attention``.

With ``impl="auto"`` the implementation follows the tensors' device: CUDA
tensors go to the hand-written kernels (``flash_attention_cuda``), which
raise on failure (there is no fallback); CPU tensors go to the plain
versions. Under autograd (grad enabled and an input that requires it),
``impl="auto"`` goes through ``FlashAttention``, whose forward is the
kernel with its log-sum-exp and whose backward is the backward kernel
(``flash_attention_bwd_cuda``), on CUDA tensors; on CPU tensors through
the plain ``attention_mef`` (``blocked.py``), the reference's training
path. Without autograd a CPU forward is ``attention_ref``, as before.

The reference's other names: ``impl="ref"`` runs the naive plain version
on any device (the yardstick a run on the card compares the kernel's path
with), ``"blocked"`` the plain ``attention_mef`` and ``"blocked_ad"`` the
plain ``attention_blocked`` (autograd through its loop) on any device. The
kernels mask ragged lengths themselves, so nothing is padded to tile
multiples.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.blocked import (attention_blocked,
                                                         attention_mef)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda, tma_ready)
from repro_torch.kernels.flash_attention.ref import IntLike, attention_ref

IMPLS = ("auto", "ref", "blocked", "blocked_ad")


class FlashAttention(torch.autograd.Function):
    """Attention on the card under autograd: the forward kernel, which also
    writes the log-sum-exp, keeps ``(q, k, v, o, lse)``; the backward is
    the backward kernel (one call: delta, dK/dV, dQ)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, causal, window, softcap,
                scale):
        o, lse = flash_attention_cuda(q, k, v, kv_len=kv_len,
                                      q_offset=q_offset, causal=causal,
                                      window=window, softcap=softcap,
                                      scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(kv_len=kv_len, q_offset=q_offset, causal=causal,
                        window=window, softcap=softcap, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # an incoming gradient may be any view: copied to a new tensor
        # unless the kernel takes it as it lies
        if not tma_ready(do):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                              **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def attention(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,
    kv_len: IntLike = None,
    q_offset: IntLike = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention, ``[B, Hq, Sq, D]`` in q's dtype. ``impl``: auto | ref |
    blocked | blocked_ad."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (expected one of "
                         f"{IMPLS})")
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal, window=window,
              softcap=softcap, scale=scale)
    if impl == "blocked":
        return attention_mef(q, k, v, **kw)
    if impl == "blocked_ad":
        return attention_blocked(q, k, v, **kw)
    card = impl == "auto" and q.device.type == "cuda"
    if impl == "auto" and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        if card:
            return FlashAttention.apply(q, k, v, kv_len, q_offset, causal,
                                        window, float(softcap), scale)
        return attention_mef(q, k, v, **kw)
    return (flash_attention_cuda if card else attention_ref)(q, k, v, **kw)

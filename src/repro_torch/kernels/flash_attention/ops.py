"""Public attention entry point of the transformer models: the port of the
JAX package's ``kernels/flash_attention/ops.py`` ``attention`` for the serve
path.

With ``impl="auto"`` the implementation follows the tensors' device: CUDA
tensors go to the hand-written kernel (``flash_attention_cuda``), which
raises on failure (there is no fallback); CPU tensors go to the plain
version (``attention_ref``). ``impl="ref"`` runs the plain version on any
device (the reference's ``impl="ref"``): the yardstick a run on the card
compares the kernel's path with. The kernel masks ragged lengths itself, so nothing is
padded to tile multiples. The reference's differentiable train paths
(``attention_blocked``, ``attention_mef``) wait for the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import IntLike, attention_ref

IMPLS = ("auto", "ref")


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
    """Attention forward, ``[B, Hq, Sq, D]`` in q's dtype. ``impl``: auto |
    ref."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (expected one of "
                         f"{IMPLS})")
    fn = (flash_attention_cuda if impl == "auto" and q.device.type == "cuda"
          else attention_ref)
    return fn(q, k, v, kv_len=kv_len, q_offset=q_offset, causal=causal,
              window=window, softcap=softcap, scale=scale)

"""Plain PyTorch attention with the LM archs' variants: the port of the JAX
package's ``kernels/flash_attention/ref.py`` (``attention_ref``).

Supports causal masking, GQA (n_q_heads a multiple of n_kv_heads), a
sliding window (keys in ``(qpos - w, qpos]``), logit soft-capping and an
explicit kv length (``[]`` or ``[B]``) for decoding against a partly filled
cache. Naive O(S^2): it materialises the float32 ``[B, Hq, Sq, Skv]``
scores. It is the CPU path of ``ops.attention`` and the oracle the CUDA
kernel is held to on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30

IntLike = Union[int, torch.Tensor, None]


def attention_ref(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, D]
    causal: bool = True,
    window: int = 0,            # 0 = full; else keys within (qpos - w, qpos]
    softcap: float = 0.0,
    scale: Optional[float] = None,
    kv_len: IntLike = None,     # int32 [] or [B]: valid kv prefix
    q_offset: IntLike = None,   # int32 []: global position of q[:, :, 0]
) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    kk = k.repeat_interleave(group, dim=1)  # [B, Hq, Skv, D]
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float())
    s = s * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)

    q_pos = torch.arange(Sq, dtype=torch.int32, device=dev)
    if isinstance(q_offset, int):
        q_pos = q_pos + q_offset
    elif q_offset is not None:
        q_pos = q_pos + q_offset.to(device=dev, dtype=torch.int32)
    k_pos = torch.arange(Skv, dtype=torch.int32, device=dev)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    mask = mask[None, None].expand(B, 1, Sq, Skv)
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, dtype=torch.int32,
                              device=dev).reshape(-1)       # [] or [B] -> [B']
        klm = k_pos[None, :] < kvl[:, None]                 # [B', Skv]
        mask = mask & klm[:, None, None, :]

    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key (fully masked) produce zeros, not NaNs
    p = p.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return o.to(q.dtype)

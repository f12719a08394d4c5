"""Plain PyTorch CIN layer: the port of the JAX package's
``kernels/cin/ref.py``.

One CIN layer (arXiv:1803.05170, Eq. 6):

  X^{k+1}[b, n, d] = sum_{h, m} W[n, h, m] * X^k[b, h, d] * X^0[b, m, d]

i.e. the field-wise outer product of the current hidden map with the base
embeddings, compressed along (h, m) by learned filters. It materialises
the outer product ``Z[B, H, m, D]``: at xdeepfm's widths 5.1 GB per 16,384
rows, and 81.8 GB (more than the card holds) at a serving batch of
262,144. It is the CPU path of ``ops.cin_layer`` and the oracle the CUDA
kernel is held to on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch


def cin_layer_ref(x0: torch.Tensor, xk: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m] -> [B, H2, D]."""
    z = torch.einsum("bhd,bmd->bhmd", xk, x0)
    return torch.einsum("bhmd,nhm->bnd", z, w)


def cin_ref(x0: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Full CIN stack; returns the concatenated per-layer sum-pooling
    [B, sum(H_k)] used as the CIN logit features."""
    xk = x0
    pooled = []
    for w in weights:
        xk = cin_layer_ref(x0, xk, w)
        pooled.append(xk.sum(dim=-1))
    return torch.cat(pooled, dim=-1)

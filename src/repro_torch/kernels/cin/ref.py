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

The layer's three gradients, for ``dy = dL/dout [B, H2, D]``, in the same
einsum idiom (each is what autograd of ``cin_layer_ref`` gives, without
keeping Z for the backward):

  dxk[b, h, d] = sum_{n, m} W[n, h, m] dy[b, n, d] x0[b, m, d]
  dx0[b, m, d] = sum_{n, h} W[n, h, m] dy[b, n, d] xk[b, h, d]
  dW[n, h, m]  = sum_{b, d} dy[b, n, d] xk[b, h, d] x0[b, m, d]

The first two are CIN layers themselves: ``dxk = cin_layer_ref(x0, dy,
W.permute(1, 0, 2))`` and ``dx0 = cin_layer_ref(xk, dy, W.permute(2, 0,
1))``; the third sums over the batch. ``cin_dx_ref`` gives the first two
reassociated around one intermediate, as the card's kernel computes them:

  U[b, h, m, d] = sum_n W[n, h, m] dy[b, n, d]
  dx0[b, m, d]  = sum_h xk[b, h, d] U[b, h, m, d]
  dxk[b, h, d]  = sum_m x0[b, m, d] U[b, h, m, d]
"""
from __future__ import annotations

from typing import Sequence

import torch


def cin_layer_ref(x0: torch.Tensor, xk: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m] -> [B, H2, D]."""
    z = torch.einsum("bhd,bmd->bhmd", xk, x0)
    return torch.einsum("bhmd,nhm->bnd", z, w)


def cin_dxk_ref(x0: torch.Tensor, dy: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], dy [B, H2, D], w [H2, H, m] -> dxk [B, H, D]."""
    z = torch.einsum("bnd,bmd->bnmd", dy, x0)
    return torch.einsum("bnmd,nhm->bhd", z, w)


def cin_dx0_ref(xk: torch.Tensor, dy: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """xk [B, H, D], dy [B, H2, D], w [H2, H, m] -> dx0 [B, m, D]."""
    z = torch.einsum("bnd,bhd->bnhd", dy, xk)
    return torch.einsum("bnhd,nhm->bmd", z, w)


def cin_dx_ref(x0: torch.Tensor, xk: torch.Tensor, dy: torch.Tensor,
               w: torch.Tensor) -> tuple:
    """x0 [B, m, D], xk [B, H, D], dy [B, H2, D], w [H2, H, m] -> (dx0 [B,
    m, D], dxk [B, H, D]), reassociated around U [B, H, m, D]."""
    u = torch.einsum("bnd,nhm->bhmd", dy, w)
    return (torch.einsum("bhd,bhmd->bmd", xk, u),
            torch.einsum("bmd,bhmd->bhd", x0, u))


def cin_dw_ref(x0: torch.Tensor, xk: torch.Tensor,
               dy: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], dy [B, H2, D] -> dW [H2, H, m]."""
    z = torch.einsum("bhd,bmd->bhmd", xk, x0)
    return torch.einsum("bhmd,bnd->nhm", z, dy)


def cin_ref(x0: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Full CIN stack; returns the concatenated per-layer sum-pooling
    [B, sum(H_k)] used as the CIN logit features."""
    xk = x0
    pooled = []
    for w in weights:
        xk = cin_layer_ref(x0, xk, w)
        pooled.append(xk.sum(dim=-1))
    return torch.cat(pooled, dim=-1)

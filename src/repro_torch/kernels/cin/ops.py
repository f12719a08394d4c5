"""Public CIN entry points of the recsys model: the port of the JAX
package's ``kernels/cin/ops.py`` (``cin_layer``, ``cin``).

With ``impl="auto"`` the implementation follows the tensors' device: CUDA
tensors go to the hand-written kernel (``cin_layer_cuda``), which raises on
failure (there is no fallback); CPU tensors go to the plain version
(``cin_layer_ref``). ``impl="ref"`` runs the plain version on any device
(the reference's ``impl="ref"``): the yardstick a run on the card compares
the kernel's path with. The reference's ``d_tile`` (a TPU tiling of D) has
no counterpart: the kernel masks the ragged D itself.

Under autograd (grad enabled and an input that requires it), ``impl="auto"``
goes through ``CinLayer``, whose backward is the gradient kernels on CUDA
tensors (one ``cin_dx_cuda`` for dx0 and dxk, one ``cin_dw_cuda``) and
their plain versions on the CPU. It keeps x0, xk and W for the backward,
never the outer product Z that autograd of the plain layer keeps (20.4 GB
at an H-200 layer of the training batch). ``impl="ref"`` stays the plain einsums
under autograd, as the reference's ``impl="ref"`` trains. Without autograd
a forward is the dispatch above and nothing more.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.cin.kernel import (cin_dw_cuda, cin_dx_cuda,
                                            cin_layer_cuda)
from repro_torch.kernels.cin.ref import (cin_dw_ref, cin_dx0_ref, cin_dxk_ref,
                                         cin_layer_ref)

IMPLS = ("auto", "ref")


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


class CinLayer(torch.autograd.Function):
    """One CIN layer whose gradients are the hand-written kernels on the
    card: dx0 and dxk in one launch, dW in another. Each gradient is
    computed only where its input needs it; a tensor passed as both x0 and
    xk (layer 1) gets both, summed by autograd."""

    @staticmethod
    def forward(ctx, x0, xk, w):
        ctx.save_for_backward(x0, xk, w)
        return (cin_layer_cuda if _on_card(x0) else cin_layer_ref)(x0, xk, w)

    @staticmethod
    def backward(ctx, dy):
        x0, xk, w = ctx.saved_tensors
        dy = dy.contiguous()
        card = _on_card(x0)
        need_x0, need_xk, need_w = ctx.needs_input_grad
        if card:
            dx0, dxk = (cin_dx_cuda(x0, xk, dy, w, need_x0, need_xk)
                        if need_x0 or need_xk else (None, None))
        else:
            dx0 = cin_dx0_ref(xk, dy, w) if need_x0 else None
            dxk = cin_dxk_ref(x0, dy, w) if need_xk else None
        dw = ((cin_dw_cuda if card else cin_dw_ref)(x0, xk, dy)
              if need_w else None)
        return dx0, dxk, dw


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m] -> [B, H2, D]. ``impl``:
    auto | ref."""
    if impl not in IMPLS:
        raise ValueError(f"unknown cin impl {impl!r} (expected one of "
                         f"{IMPLS})")
    if impl == "ref":
        return cin_layer_ref(x0, xk, w)
    if torch.is_grad_enabled() and (x0.requires_grad or xk.requires_grad
                                    or w.requires_grad):
        return CinLayer.apply(x0, xk, w)
    return (cin_layer_cuda if _on_card(x0) else cin_layer_ref)(x0, xk, w)


def cin(x0: torch.Tensor, weights: Sequence[torch.Tensor],
        impl: str = "auto") -> torch.Tensor:
    """Full CIN stack with per-layer sum pooling -> [B, sum(H_k)]."""
    xk = x0
    pooled = []
    for w in weights:
        xk = cin_layer(x0, xk, w, impl=impl)
        pooled.append(xk.sum(dim=-1))
    return torch.cat(pooled, dim=-1)

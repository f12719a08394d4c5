"""Public CIN entry points of the recsys model: the port of the JAX
package's ``kernels/cin/ops.py`` (``cin_layer``, ``cin``).

With ``impl="auto"`` the implementation follows the tensors' device: CUDA
tensors go to the hand-written kernel (``cin_layer_cuda``), which raises on
failure (there is no fallback); CPU tensors go to the plain version
(``cin_layer_ref``). ``impl="ref"`` runs the plain version on any device
(the reference's ``impl="ref"``): the yardstick a run on the card compares
the kernel's path with. The reference's ``d_tile`` (a TPU tiling of D) has
no counterpart: the kernel masks the ragged D itself.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.cin.kernel import cin_layer_cuda
from repro_torch.kernels.cin.ref import cin_layer_ref

IMPLS = ("auto", "ref")


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m] -> [B, H2, D]. ``impl``:
    auto | ref."""
    if impl not in IMPLS:
        raise ValueError(f"unknown cin impl {impl!r} (expected one of "
                         f"{IMPLS})")
    fn = (cin_layer_cuda if impl == "auto" and x0.device.type == "cuda"
          else cin_layer_ref)
    return fn(x0, xk, w)


def cin(x0: torch.Tensor, weights: Sequence[torch.Tensor],
        impl: str = "auto") -> torch.Tensor:
    """Full CIN stack with per-layer sum pooling -> [B, sum(H_k)]."""
    xk = x0
    pooled = []
    for w in weights:
        xk = cin_layer(x0, xk, w, impl=impl)
        pooled.append(xk.sum(dim=-1))
    return torch.cat(pooled, dim=-1)

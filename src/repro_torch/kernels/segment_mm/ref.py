"""Plain PyTorch ``segment_mm``: the port of the JAX package's
``kernels/segment_mm/ref.py``.

  Y[n, :] = sum over edges e with dst[e] == n of coeff[e] * X[src[e], :]

Message passing with one scalar coefficient per edge (GCN's normalised
adjacency). It materialises the messages ``X[src] * coeff`` (E x D) and
sums them with ``index_add_``, in the dtype of ``x`` and ``coeff`` (the
card's checks run it in float64). It is the CPU path of ``ops.segment_mm``
and ``ops.segment_mm_csr`` and the oracle the CUDA kernel is held to on the
card; on the card its float32 sums are atomics, in no fixed order.
"""
from __future__ import annotations

import torch


def segment_mm_ref(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   coeff: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """x [N_src, D], src / dst int [E], coeff [E] -> [n_nodes, D]."""
    msgs = x[src] * coeff[:, None]
    out = torch.zeros((n_nodes, x.shape[1]), dtype=msgs.dtype,
                      device=x.device)
    return out.index_add_(0, dst, msgs)

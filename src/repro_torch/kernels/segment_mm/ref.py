"""Plain PyTorch ``segment_mm``: the port of the JAX package's
``kernels/segment_mm/ref.py``.

  Y[n, :] = sum over edges e with dst[e] == n of coeff[e] * X[src[e], :]

Message passing with one scalar coefficient per edge (GCN's normalised
adjacency; 1 where a GNN sums per-edge rows). It materialises the messages
``X[src] * coeff`` for ``CHUNK`` edges at a time and sums them with
``index_add_`` in edge order, in the dtype of ``x`` and ``coeff`` (the
card's checks run it in float64); the chunks bound its temporary at
``ogb_products``' size and change no sum on the CPU, which adds in edge
order either way. It is the CPU path of ``ops.segment_mm``
and ``ops.segment_mm_csr`` and the oracle the CUDA kernel is held to on the
card; on the card its float32 sums are atomics, in no fixed order.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 21      # edges whose messages are materialised at a time


def segment_mm_ref(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   coeff: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """x [N_src, D], src / dst int [E], coeff [E] -> [n_nodes, D]."""
    out = torch.zeros((n_nodes, x.shape[1]),
                      dtype=torch.promote_types(x.dtype, coeff.dtype),
                      device=x.device)
    for lo in range(0, dst.shape[0], CHUNK):
        hi = lo + CHUNK
        out.index_add_(0, dst[lo:hi], x[src[lo:hi]] * coeff[lo:hi, None])
    return out

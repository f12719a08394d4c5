"""Segment reductions with the paper's tie-break semantics.

A Δ-growing step updates node v from edge (u, v) with the candidate of the
smallest d, then the smallest center id, then the smallest realized path
weight. ``segment_min_triple`` realizes that lexicographic argmin as three
chained ``scatter_reduce(..., "amin")`` passes, as the JAX package's
``graph/segment_ops.py`` does with ``segment_min``. An empty segment holds
the dtype max, like ``jax.ops.segment_min``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _sentinel(x: torch.Tensor) -> int:
    """Dtype-matched masking sentinel: the engine's INF for int32, the
    dtype max for wider integers (the quotient coalesces int64 weights)."""
    if x.dtype.is_floating_point:
        return torch.finfo(x.dtype).max
    return torch.iinfo(x.dtype).max


def segment_min(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min``: min of ``values`` rows per segment id along
    axis 0; ``seg`` holds ids in ``[0, num_segments)``."""
    out = torch.full((num_segments,) + tuple(values.shape[1:]),
                     _sentinel(values), dtype=values.dtype,
                     device=values.device)
    idx = seg.to(torch.int64)
    if values.dim() > 1:
        idx = idx.view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, idx, values, "amin", include_self=True)


def segment_min_pair(
    cand_d: torch.Tensor,
    cand_c: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic (d, c) segment-min. Returns per-segment (d_min, c_min)."""
    d_min = segment_min(cand_d, seg, num_segments)
    is_winner = cand_d == d_min[seg]
    c_masked = torch.where(is_winner, cand_c, _sentinel(cand_c))
    return d_min, segment_min(c_masked, seg, num_segments)


def segment_min_triple(
    cand_d: torch.Tensor,
    cand_c: torch.Tensor,
    cand_p: torch.Tensor,
    seg: torch.Tensor,
    num_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d, c, pathw) lexicographic segment-min (three chained passes)."""
    d_min = segment_min(cand_d, seg, num_segments)
    w1 = cand_d == d_min[seg]
    c_min = segment_min(torch.where(w1, cand_c, _sentinel(cand_c)), seg,
                        num_segments)
    w2 = w1 & (cand_c == c_min[seg])
    p_min = segment_min(torch.where(w2, cand_p, _sentinel(cand_p)), seg,
                        num_segments)
    return d_min, c_min, p_min

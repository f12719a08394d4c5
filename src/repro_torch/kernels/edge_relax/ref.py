"""Plain PyTorch version of the Δ-growing edge relaxation (paper Section 3),
the port of the JAX package's ``kernels/edge_relax/ref.py``.

Per edge e = (src, dst, w), with gathered source planes:
  live candidate   d_src + w      when d_src < Δ and w < Δ       (light edge)
  relay candidate  max(w+rw0, 0)  when rw0 < BIG and that value < Δ
                                  (a covered source relays its center's
                                  wave with the contraction offset folded in)
Relay beats live on the same edge.

Per destination node: lexicographic (d, c, pathw) tuple-min over incident
edges; INF in all three planes where a node has no candidate.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph.segment_ops import segment_min_triple

INF = 2**31 - 1
BIG = 2**30


def edge_relax_candidates(
    d_src: torch.Tensor,
    c_src: torch.Tensor,
    p_src: torch.Tensor,
    rw0_src: torch.Tensor,
    rc_src: torch.Tensor,
    rp_src: torch.Tensor,
    w: torch.Tensor,
    mask,
    delta,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-edge (cand_d, cand_c, cand_p), int32; INF where inadmissible.

    The int32 adds cannot overflow: an admitted live source has
    ``d_src < Δ <= 2^30`` and ``w < Δ``; the relay term clamps ``rw0 >= BIG``
    to BIG before adding ``w <= 2^30 - 1``; ``p_safe < 2^30``.
    """
    live_ok = (d_src < delta) & (w < delta) & mask
    live_d = torch.where(live_ok, torch.where(live_ok, d_src, 0) + w, INF)
    w_red = torch.clamp_min(w + torch.clamp_max(rw0_src, BIG), 0)
    relay_ok = (rw0_src < BIG) & (w_red < delta) & mask
    cand_d = torch.where(relay_ok, w_red, live_d)
    cand_c = torch.where(relay_ok, rc_src, torch.where(live_ok, c_src, INF))
    p_base = torch.where(relay_ok, rp_src, torch.where(live_ok, p_src, 0))
    p_safe = torch.where(p_base >= BIG, 0, p_base)
    cand_p = torch.where(relay_ok | live_ok, p_safe + w, INF)
    return cand_d, cand_c, cand_p


def edge_relax_ref(
    d_src: torch.Tensor,
    c_src: torch.Tensor,
    p_src: torch.Tensor,
    rw0_src: torch.Tensor,
    rc_src: torch.Tensor,
    rp_src: torch.Tensor,
    w: torch.Tensor,
    dst: torch.Tensor,
    mask,
    delta,
    n_nodes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-node (d_min, c_min, p_min); INF where no candidate."""
    cand_d, cand_c, cand_p = edge_relax_candidates(
        d_src, c_src, p_src, rw0_src, rc_src, rp_src, w, mask, delta)
    return segment_min_triple(cand_d, cand_c, cand_p, dst, n_nodes)

"""The Δ-growing step (paper Section 3) and the PartialGrowth loop, the port
of the JAX package's ``core/delta_growing.py``.

One growing step = one relaxation superstep over all edges; per
destination, the lexicographic (d, c, pathw) tuple-min. The PartialGrowth
stopping rule:
  repeat until no state updated            ("complete" variant)
         or |{d < Δ}| >= target/2          ("stop" variant)
         or k == num_it                    (2n/tau cap)

The loop runs through ``core/chunked.chunked_while``: the stop rule is
evaluated on the device before every superstep and gates the update, and
the host reads one packed (more, k, changed, reached) vector per chunk.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.chunked import DEFAULT_CHUNK, chunked_while
from repro_torch.core.state import EngineState, relay_planes
from repro_torch.graph.segment_ops import segment_min_triple
from repro_torch.kernels.edge_relax.ref import edge_relax_candidates


@dataclass
class GrowthStats:
    steps: int          # growing steps executed in this call
    reached: int        # |{uncovered non-center: d < Δ}|
    changed_last: bool  # whether the final step still changed state
    syncs: int = 0      # host reads spent (one per chunk or fused launch)
    # fused path counters (0 on the unfused paths; kernels/edge_relax/
    # megakernel.py): fused calls (kernel launches on the card, plain-version
    # calls on the CPU), supersteps run inside them, skipped rows
    kernel_launches: int = 0
    kernel_supersteps: int = 0
    dead_blocks: int = 0


def growth_loop(
    state: EngineState,
    relax_step,
    frozen: torch.Tensor,
    delta: int,
    half_target: int,
    num_it: int,
    variant: str,
    chunk: int = DEFAULT_CHUNK,
):
    """THE PartialGrowth loop, shared by every backend.

    ``relax_step(s) -> (d_min, c_min, p_min)`` is the backend's one-superstep
    relax (plain segment ops or the CUDA kernel); the stopping rule, update
    mask and stats live only here.
    """
    if variant not in ("stop", "complete"):
        raise ValueError(f"variant must be stop | complete, got {variant!r}")
    dev = state.d.device
    live = ~frozen

    def reached_count(s: EngineState) -> torch.Tensor:
        return torch.sum(live & (s.d < delta))

    def cond(carry):
        s, k, changed = carry
        more = changed & (k < num_it)
        if variant == "stop":
            more = more & (reached_count(s) < half_target)
        return more

    def body(carry, more):
        s, k, changed = carry
        d_min, c_min, p_min = relax_step(s)
        upd = more & live & (d_min < s.d)
        s = s.replace(
            d=torch.where(upd, d_min, s.d),
            c=torch.where(upd, c_min, s.c),
            pathw=torch.where(upd, p_min, s.pathw),
        )
        changed = torch.where(more, upd.any(), changed)
        return s, k + more.to(torch.int32), changed

    init = (state, torch.zeros((), dtype=torch.int32, device=dev),
            torch.ones((), dtype=torch.bool, device=dev))
    (final, _, _), host, reads = chunked_while(
        cond, body, init, chunk=chunk,
        stats=lambda c: [c[1], c[2], reached_count(c[0])],
        reason="grow chunk: packed (more, k, changed, reached)")
    return final, GrowthStats(steps=int(host[1]), reached=int(host[3]),
                              changed_last=bool(host[2]), syncs=reads)


def partial_growth(
    state: EngineState,
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    delta: int,
    half_target: int,
    num_it: int,
    n_nodes: int,
    variant: str = "stop",
    chunk: int = DEFAULT_CHUNK,
):
    """Paper's PartialGrowth(G, X, Δ, num_it) on flat edge arrays with the
    plain PyTorch superstep. ``half_target``: |uncovered at stage start|/2;
    ``variant``: "stop" halts once the goal is met, "complete" runs to
    quiescence."""
    # relay planes depend only on covered/final_*/offset, which a grow call
    # never changes: derive them once
    rw0, rc, rp, frozen = relay_planes(state)
    idx = src.to(torch.int64)
    rw0_s, rc_s, rp_s = rw0[idx], rc[idx], rp[idx]

    def relax_step(s: EngineState):
        cand_d, cand_c, cand_p = edge_relax_candidates(
            s.d[idx], s.c[idx], s.pathw[idx], rw0_s, rc_s, rp_s,
            weight, True, delta)
        return segment_min_triple(cand_d, cand_c, cand_p, dst, n_nodes)

    return growth_loop(state, relax_step, frozen, delta, half_target, num_it,
                       variant, chunk)

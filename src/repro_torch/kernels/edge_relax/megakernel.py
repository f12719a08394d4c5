"""Persistent fused grow supersteps: up to K Δ-growing supersteps per launch,
the port of the JAX package's ``kernels/edge_relax/megakernel.py``.

A grow call is a loop of supersteps. Unfused, every superstep is one relax
launch plus the eager merge around it, and the host reads the stop rule
once per chunk of supersteps (``core/chunked.py``). Here one launch of the
cooperative CUDA kernel (``csrc/megakernel.cu``) runs up to K supersteps:

  * the PartialGrowth stop rule (``core.delta_growing.growth_loop``) is
    evaluated on the device before every superstep, so a launch that
    reaches the stop or quiescence early leaves its remaining slots idle
    and uncounted; the result is byte-identical to the unfused loop;
  * a frontier bitmap ``front`` (1 where a node's tuple changed in the
    previous superstep) lets a destination row none of whose in-edge
    sources changed skip its scan (sound: its candidates were merged
    already). The port's skip unit is the ROW (the TPU kernel's was an edge
    block); frozen rows are skipped too. Skipped rows are counted in
    ``COL_DEAD``. The kernel finds the rows to run by marking the
    out-neighbours of changed rows through the graph's out-edge CSR
    (``RelaxGraph.out_csr``); the plain version finds the same rows from
    ``front[src]``;
  * one stats row per executed superstep and a summary row at index K,
    read by the host once per launch.

``fused_grow_supersteps`` sends CUDA tensors to the kernel and CPU tensors
to ``fused_grow_supersteps_plain``, the same function in plain PyTorch (K
gated supersteps of ``edge_relax_plain``, the frontier rule and the stats
rows), which the tests and ``chip_smoke.py`` also hold the kernel against.
There is no other branch and no fallback.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch import guard
from repro_torch.kernels.edge_relax.kernel import STATS_W, megakernel_cuda
from repro_torch.kernels.edge_relax.ops import RelaxGraph, edge_relax_plain
from repro_torch.kernels.edge_relax.ref import INF

# stats layout: one row per fused superstep + one summary row (index K).
# Per-superstep rows: executed flag, nodes changed, reached count after the
# merge, cumulative skipped rows, continue flag. Summary row: supersteps
# executed in this launch, final changed flag, final reached count, skipped
# rows, continue flag for the NEXT launch. Columns 5-7 stay 0.
COL_EXECUTED = 0
COL_CHANGED = 1
COL_REACHED = 2
COL_DEAD = 3
COL_CONT = 4

DEFAULT_K_FUSED = 8

__all__ = ["STATS_W", "COL_EXECUTED", "COL_CHANGED", "COL_REACHED",
           "COL_DEAD", "COL_CONT", "DEFAULT_K_FUSED", "MegaParams",
           "fused_grow_supersteps", "fused_grow_supersteps_plain",
           "megakernel_growth_loop"]


class MegaParams(NamedTuple):
    """The scalars of one launch (the reference's ``params`` int32 [8])."""

    delta: int
    half_target: int
    num_it: int
    steps_base: int     # supersteps already run in this grow call
    stop_variant: int   # 1 = "stop", 0 = "complete"


def fused_grow_supersteps_plain(
    planes: Sequence[torch.Tensor],
    relay: Sequence[torch.Tensor],
    frozen: torch.Tensor,
    front: torch.Tensor,
    g: RelaxGraph,
    params: MegaParams,
    k_fused: int,
    skip: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """The megakernel in plain PyTorch, on any device: ``k_fused`` gated
    supersteps. ``skip=False`` keeps the candidates of skipped rows (the
    tests' check that the skip is sound); the skipped-row count is the same
    either way."""
    d, c, p = planes
    rw0, rc, rp = relay
    delta, half_target, num_it, steps_base, stop_variant = map(int, params)
    dev = d.device
    n = g.n_nodes
    live = ~frozen
    src = g.src.to(torch.int64)
    dst = g.dst.to(torch.int64)

    def reached_count(dd):
        return torch.sum(live & (dd < delta))

    def cond(changed, executed, reached):
        more = changed & (steps_base + executed < num_it)
        if stop_variant:
            more = more & (reached < half_target)
        return more

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = torch.zeros((k_fused + 1, STATS_W), dtype=torch.int32, device=dev)
    running = torch.ones((), dtype=torch.bool, device=dev)
    changed = torch.ones((), dtype=torch.bool, device=dev)
    executed = zero
    skipped = zero
    reached = reached_count(d)
    front = front.to(torch.bool)
    for j in range(k_fused):
        running = running & cond(changed, executed, reached)
        hits = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, dst, front[src].to(torch.int32))
        row_runs = live & (hits > 0)
        dm, cm, pm = edge_relax_plain((d, c, p, rw0, rc, rp), g, delta)
        if skip:
            dm = torch.where(row_runs, dm, INF)
        upd = running & live & (dm < d)
        d = torch.where(upd, dm, d)
        c = torch.where(upd, cm, c)
        p = torch.where(upd, pm, p)
        front = torch.where(running, upd, front)
        n_changed = upd.sum()
        changed = torch.where(running, n_changed > 0, changed)
        executed = executed + running
        reached = reached_count(d)
        skipped = skipped + torch.where(running, n - row_runs.sum(), zero)
        row = torch.stack([torch.ones_like(zero), n_changed, reached, skipped,
                           cond(changed, executed, reached).to(torch.int64),
                           zero, zero, zero])
        stats[j] = torch.where(running, row, zero).to(torch.int32)
    stats[k_fused] = torch.stack([
        executed, changed.to(torch.int64), reached, skipped,
        cond(changed, executed, reached).to(torch.int64), zero, zero,
        zero]).to(torch.int32)
    return d, c, p, front.to(torch.uint8), stats


def fused_grow_supersteps(
    planes: Sequence[torch.Tensor],
    relay: Sequence[torch.Tensor],
    frozen: torch.Tensor,
    front: torch.Tensor,
    g: RelaxGraph,
    params: MegaParams,
    k_fused: int,
) -> Tuple[torch.Tensor, ...]:
    """Up to ``k_fused`` supersteps: the cooperative kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    ``(d, c, p, front, stats)``; ``stats[k_fused]`` is the summary row."""
    if g.row_ptr.is_cuda:
        return megakernel_cuda(planes, relay, frozen, front, g.row_ptr,
                               g.src, g.w, *g.out_csr(), params, k_fused)
    return fused_grow_supersteps_plain(planes, relay, frozen, front, g,
                                       params, k_fused)


def megakernel_growth_loop(state, g: RelaxGraph, delta: int,
                           half_target: int, num_it: int, variant: str,
                           k_fused: int = DEFAULT_K_FUSED):
    """PartialGrowth where each step of the host loop is ONE fused launch
    of up to ``k_fused`` supersteps, followed by one read of its summary
    row; the loop goes on while the summary's continue flag is set.

    Byte-identical to ``growth_loop`` with the plain relax. ``front`` starts
    all-ones in each grow call (Δ and the relay planes may have changed)
    and is carried across the launches of the call. Returns
    ``(state, GrowthStats)`` with ``syncs == kernel_launches`` (one read per
    launch) and ``kernel_supersteps == steps``.
    """
    from repro_torch.core.delta_growing import GrowthStats
    from repro_torch.core.state import relay_planes

    if variant not in ("stop", "complete"):
        raise ValueError(f"variant must be stop | complete, got {variant!r}")
    if k_fused < 1:
        raise ValueError(f"k_fused must be >= 1, got {k_fused}")
    rw0, rc, rp, frozen = relay_planes(state)
    front = torch.ones(state.n, dtype=torch.uint8, device=state.d.device)
    planes = (state.d, state.c, state.pathw)
    stop_variant = int(variant == "stop")
    steps = launches = dead = 0
    while True:
        params = MegaParams(int(delta), int(half_target), int(num_it), steps,
                            stop_variant)
        *planes, front, stats = fused_grow_supersteps(
            planes, (rw0, rc, rp), frozen, front, g, params, k_fused)
        launches += 1
        summ = guard.fetch(stats[k_fused],
                           reason="fused grow: launch summary row")
        steps += int(summ[COL_EXECUTED])
        dead += int(summ[COL_DEAD])
        if not summ[COL_CONT]:
            break
    d, c, p = planes
    return state.replace(d=d, c=c, pathw=p), GrowthStats(
        steps=steps, reached=int(summ[COL_REACHED]),
        changed_last=bool(summ[COL_CHANGED]), syncs=launches,
        kernel_launches=launches, kernel_supersteps=steps, dead_blocks=dead)

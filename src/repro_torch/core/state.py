"""Engine state for the weighted decomposition (paper Alg. 1), the port of
the JAX package's ``core/state.py``.

Per-node planes (int32 unless noted):

  in-stage (reset when a new batch of centers is sampled):
    d       tentative distance in the reduced graph from the owning center
    c       tentative center id (INF = unassigned)
    pathw   realized path weight from the center in the ORIGINAL graph

  persistent:
    final_c     cluster assignment (INF until covered)
    final_pathw dist-from-center upper bound frozen at cover time
    offset      for covered nodes d_at_cover - Δ_at_cover (may be negative)
    covered     bool: assigned in a previous stage (frozen, emits as relay)
    is_center   bool: permanent cluster center

Every function returns a new ``EngineState``; no plane is updated in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

INF = 2**31 - 1
BIG = 2**30


@dataclass(frozen=True)
class EngineState:
    d: torch.Tensor
    c: torch.Tensor
    pathw: torch.Tensor
    final_c: torch.Tensor
    final_pathw: torch.Tensor
    offset: torch.Tensor
    covered: torch.Tensor
    is_center: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.d.shape[0])

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


def init_state(n_nodes: int, device) -> EngineState:
    z = torch.zeros(n_nodes, dtype=torch.int32, device=device)
    inf = torch.full((n_nodes,), INF, dtype=torch.int32, device=device)
    f = torch.zeros(n_nodes, dtype=torch.bool, device=device)
    return EngineState(d=inf, c=inf, pathw=inf, final_c=inf, final_pathw=inf,
                       offset=z, covered=f, is_center=f)


def pad_state(state: EngineState, n_pad: int) -> EngineState:
    """Pad the planes to ``n_pad`` slots. Tail slots are inert permanent
    centers: never sampled, never updated, never counted."""
    n = state.n
    if n_pad == n:
        return state
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < n {n}")

    def padto(x, fill):
        tail = torch.full((n_pad - n,), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    return EngineState(
        d=padto(state.d, INF),
        c=padto(state.c, INF),
        pathw=padto(state.pathw, INF),
        final_c=padto(state.final_c, INF),
        final_pathw=padto(state.final_pathw, INF),
        offset=padto(state.offset, 0),
        covered=padto(state.covered, False),
        is_center=padto(state.is_center, True),
    )


def relay_planes(state: EngineState):
    """Relay candidate planes ``(rw0, rc, rp, frozen)``: covered nodes relay
    their center's wave with the contraction offset folded in; everyone
    else gets BIG so the relay branch is inadmissible. ``frozen`` marks
    nodes that never receive updates."""
    relay = state.covered
    rw0 = torch.where(relay, state.offset, BIG)
    rc = torch.where(relay, state.final_c, INF)
    rp = torch.where(relay, state.final_pathw, INF)
    frozen = state.covered | state.is_center
    return rw0, rc, rp, frozen


def _ids(state: EngineState) -> torch.Tensor:
    return torch.arange(state.n, dtype=torch.int32, device=state.d.device)


def promote_centers(state: EngineState,
                    new_centers: torch.Tensor) -> EngineState:
    """Mark ``new_centers`` (bool mask) as permanent centers at (self, 0)."""
    ids = _ids(state)
    sel = new_centers & ~state.is_center & ~state.covered
    return state.replace(
        d=torch.where(sel, 0, state.d),
        c=torch.where(sel, ids, state.c),
        pathw=torch.where(sel, 0, state.pathw),
        final_c=torch.where(sel, ids, state.final_c),
        final_pathw=torch.where(sel, 0, state.final_pathw),
        is_center=state.is_center | sel,
    )


def promote_centers_shifted(state: EngineState, new_centers: torch.Tensor,
                            start_d: torch.Tensor) -> EngineState:
    """One-shot promote: centers enter the wave at ``d = start_d`` (the
    exponential start shift folded into the initial distance) instead of
    0. ``pathw`` still starts at 0, so ``final_pathw`` stays a realized path
    weight from the owning center."""
    ids = _ids(state)
    sel = new_centers & ~state.is_center & ~state.covered
    return state.replace(
        d=torch.where(sel, start_d, state.d),
        c=torch.where(sel, ids, state.c),
        pathw=torch.where(sel, 0, state.pathw),
        final_c=torch.where(sel, ids, state.final_c),
        final_pathw=torch.where(sel, 0, state.final_pathw),
        is_center=state.is_center | sel,
    )


def reset_in_stage(state: EngineState) -> EngineState:
    """Centers at (self, 0), everyone else unreached."""
    ids = _ids(state)
    is_c = state.is_center
    return state.replace(
        d=torch.where(is_c, 0, INF).to(torch.int32),
        c=torch.where(is_c, ids, INF),
        pathw=torch.where(is_c, 0, INF).to(torch.int32),
    )


def cover(state: EngineState, delta) -> EngineState:
    """Freeze every uncovered non-center node with in-stage d < delta and
    fold the reduction rescaling into its relay offset."""
    newly = (~state.covered) & (~state.is_center) & (state.d < delta)
    return state.replace(
        final_c=torch.where(newly, state.c, state.final_c),
        final_pathw=torch.where(newly, state.pathw, state.final_pathw),
        offset=torch.where(newly, state.d - delta, state.offset),
        covered=state.covered | newly,
    )


def uncovered_count(state: EngineState) -> torch.Tensor:
    return torch.sum((~state.covered) & (~state.is_center))


def finalize_singletons(state: EngineState) -> EngineState:
    """Remaining uncovered nodes become singleton clusters."""
    ids = _ids(state)
    rem = (~state.covered) & (~state.is_center)
    return state.replace(
        final_c=torch.where(rem, ids, state.final_c),
        final_pathw=torch.where(rem, 0, state.final_pathw),
        is_center=state.is_center | rem,
    )

"""AdamW with global-norm clipping and the WSD schedule: the port of the
JAX package's ``optim/adamw.py`` (``AdamWState``, ``init_state``,
``wsd_schedule``, ``global_norm``, ``apply_updates``).

It works on the port's parameter trees (nested dicts and lists of
tensors). Unlike the reference, which returns new trees (its launcher
donates the old buffers, ``src/repro/launch/train.py:88``), it updates
the parameters and the moments in place, leaf by leaf and in slices of at
most ``UPDATE_SLICE`` elements, so that the update's float32 scratch is a
few slices and not a copy of every gradient and moment: about 12 bytes a
parameter at the peak (bf16 weights and gradients, float32 m and v)
instead of about 26. Each element goes through the same float32
operations in the same order as before, so the results are the same
bits. It returns the parameters as tensors that share the updated
storage (detached: no gradient rides along) and the state with the same
m and v. The arithmetic is
the reference's: gradients clipped by their global norm, the moments kept
in float32, the bias correction folded into the scalars ``c1`` and
``c2s`` (no bias-corrected temporaries), and the weight decay added to
``delta`` before the step. ``step`` and ``lr`` stay device tensors, so an
update reads nothing from the device. ``torch.optim.AdamW`` is not used:
it puts ``eps`` after the bias correction of ``sqrt(v)`` and decays the
weights before the step.

Every quantity of the update is float32 whatever the parameters' type,
as the reference casts them (its schedule too, under ``jax.enable_x64``):
the new parameters are ``p`` in float32 less ``lr * delta``, cast back to
``p``'s type. Dict leaves are visited in sorted key order, the
reference's tree order (``common.tree_leaves``), so the global norm sums
its leaves in the reference's order.

``zero1_state_specs`` (a sharding decision) is not ported: the port runs
on one device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.config.base import TrainConfig

UPDATE_SLICE = 1 << 24      # elements a leaf is updated in at a time


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor      # int32 [], on the parameters' device


def init_state(params: Any) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def wsd_schedule(step: torch.Tensor, cfg: TrainConfig,
                 total_steps: int = 0) -> torch.Tensor:
    """Warmup-stable-decay, float32. Decay phase only if total_steps
    known."""
    s = step.to(torch.float32)
    lr = cfg.lr * torch.clamp_max(s / max(cfg.warmup, 1), 1.0)
    if total_steps:
        decay_start = int(0.8 * total_steps)
        frac = torch.clamp((s - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        lr = lr * (1.0 - 0.9 * frac)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 L2 norm of every leaf together, summed leaf by leaf in
    tree order from a float32 zero. A leaf of more than ``UPDATE_SLICE``
    elements is summed slice by slice, so that its float32 square is a
    slice's and not the leaf's (a full-width LM's stacked layer gradients
    would take 8 bytes a parameter more at the step's peak)."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        flat = g.reshape(-1)
        for i in range(0, flat.numel(), UPDATE_SLICE):
            total = total + torch.sum(torch.square(
                flat[i:i + UPDATE_SLICE].to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Any, state: AdamWState, grads: Any,
                  cfg: TrainConfig, total_steps: int = 0
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``(params, state, {"grad_norm", "lr"})``,
    the parameters and moments updated where they lie, the stats device
    tensors."""
    step = state.step + 1
    lr = wsd_schedule(step, cfg, total_steps)

    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    # bias correction folded into scalars: no bias-corrected temporaries
    t = step.to(torch.float32)
    c1 = 1.0 / (1 - b1 ** t)
    c2s = torch.sqrt(1 - b2 ** t)

    def update(p, m_, v_, g):
        g = g.to(torch.float32) * scale
        m_.copy_(b1 * m_ + (1 - b1) * g)
        v_.copy_(b2 * v_ + (1 - b2) * g * g)
        p32 = p.to(torch.float32)
        delta = (c1 * m_) / (torch.sqrt(v_) / c2s + eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))

    for p, m_, v_, g in zip(tree_leaves(params), tree_leaves(state.m),
                            tree_leaves(state.v), tree_leaves(grads)):
        if not (p.is_contiguous() and m_.is_contiguous()
                and v_.is_contiguous()):
            raise ValueError("apply_updates: parameters and moments must "
                             "be contiguous (they are updated in slices of "
                             "their flat views)")
        flat = [x.view(-1) for x in (p, m_, v_)] + [g.reshape(-1)]
        for i in range(0, p.numel(), UPDATE_SLICE):
            update(*(x[i:i + UPDATE_SLICE] for x in flat))
    new_params = tree_map(lambda p: p.detach(), params)
    return new_params, AdamWState(state.m, state.v, step), \
        {"grad_norm": gn, "lr": lr}

"""An independent dense version of the MoE FFN, and the rule the dispatch
is held to against it: shared by the card tests and ``chip_smoke.py``, so
that the two cannot drift apart.

``moe_ffn_dense`` computes every expert on every token and weights each
result by the pair's gate where the pair is kept. It shares only the
router (``transformer.moe_route``) with the dispatch: which pairs are kept
comes from a cumulative count over the one-hot choices in (token, choice)
order, not from the dispatch's sort and ``searchsorted``, and no pair is
copied into capacity slots. Its ``capacity`` argument plants a fault:
``fault_capacity`` is one slot fewer than the fullest expert's pairs (or
than the capacity, where an expert overflows it), which drops a pair the
dispatch keeps.

The rule is per token: ``||o - r|| <= 2^-6 ||r||`` over the token's output
row (float32, before the residual add), read as "excess", the largest
``||o - r|| / (2^-6 ||r||)`` (pass at <= 1). Both sides round the same bf16
products; they differ where cuBLAS sums a product in another order for the
dispatch's ``[C, d]`` slices than for the dense ``[T, d]`` one, which
moves an intermediate (``h W_gate``, ``h W_up``, their product, ``y``) by
a bf16 ulp (2^-8 to 2^-7 of it) here and there. Those moves are
independent and of both signs, so over a row of ``d`` outputs they sum to
about 2^-8 of the row's norm; 2^-6 leaves four times that. A pair dropped
or routed to the wrong expert moves its token's row by about its gate's
share of the row (a sixth to a half at top-6 and top-2), far past 2^-6.

The gradients (``moe_grad_excess``) are held to the same share, leaf by
leaf: the gradient in ``h`` row by row (each token's), each expert's
slice of ``w_gate``, ``w_up`` and ``w_down`` by its relative L2, and the
router and shared experts by the whole leaf's. Both sides route the same
way (they share ``moe_route``) and take the same bf16 products in the
backward; a product summed in another order moves a bf16 gradient
element by an ulp here and there, independent and of both signs, so a
token's row or an expert's slice, made of many such elements, moves by
about 2^-8 of its norm, a quarter of 2^-6. The dispatch's gradient in a
bf16 ``h`` also sums its three uses (router, dispatch, shared experts)
in bf16; the check gives the dense version ``h`` in float32, so that its
k experts' and shared experts' terms, one bf16 rounding each, sum in
float32 and the rule reads the dispatch's rounding against them. A
dropped pair takes its gate's share out of its token's row of the
gradient in ``h``, as out of the output row, and so reads far past the
rule there; in an expert's weight gradient it is one of the ``C``
tokens' terms, about ``C^-1/2`` of the slice, which the rule does not
promise to see.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config.base import MoEConfig
from repro_torch.models.transformer import (_act, moe_capacity, moe_route)

ROW_SHARE = 2.0 ** -6


def moe_keep_by_count(exp_idx: torch.Tensor, capacity: int,
                      n_experts: int) -> torch.Tensor:
    """Keep mask ``[G, Tg, k]`` of the pairs of experts ``[G, Tg, k]``: a
    pair is kept when fewer than ``capacity`` pairs of its group chose its
    expert before it in (token, choice) order."""
    G, Tg, k = exp_idx.shape
    onehot = (exp_idx.reshape(G, Tg * k, 1)
              == torch.arange(n_experts, device=exp_idx.device)).long()
    before = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
    return (before < capacity).view(G, Tg, k)


def fault_capacity(exp_idx: torch.Tensor, capacity: int,
                   n_experts: int) -> int:
    """The capacity of the planted fault: one less than the pairs the
    fullest expert of any group keeps (reads the device once)."""
    load = (exp_idx.reshape(exp_idx.shape[0], -1, 1)
            == torch.arange(n_experts, device=exp_idx.device)).sum(dim=1)
    # sync: the planted fault's capacity, read once per check
    return min(capacity, int(load.max())) - 1


def moe_ffn_dense(h: torch.Tensor, lp: dict, cfg: MoEConfig,
                  capacity: Optional[int] = None) -> torch.Tensor:
    """The MoE FFN of the normalised tokens ``h`` ``[G, Tg, d]`` as every
    expert on every token: float32 ``[G, Tg, d]`` (float64 for a float64
    ``h``) before the residual add, shared experts included. The products
    take ``h`` in the weights' dtype. ``capacity`` defaults to the
    dispatch's."""
    G, Tg, d = h.shape
    E = cfg.n_experts
    dt = lp["w_gate"].dtype

    def x():
        # a cast per product, so that a float32 h (the gradient check's,
        # holding model-dtype values) sums its gradient in float32
        return h.to(dt)

    _, gate_vals, exp_idx, _ = moe_route(x(), lp["router"], cfg)
    cap = moe_capacity(Tg, cfg) if capacity is None else capacity
    kept = gate_vals * moe_keep_by_count(exp_idx, cap, E)
    # each token's weight of each expert (a token picks an expert once),
    # in float32 (float64 for a float64 h), as the dispatch's gates
    wt = torch.promote_types(h.dtype, torch.float32)
    weight = torch.zeros((G, Tg, E), dtype=wt, device=h.device)
    weight.scatter_add_(2, exp_idx, kept)
    out = torch.zeros((G, Tg, d), dtype=wt, device=h.device)
    for e in range(E):
        gu = (_act(x() @ lp["w_gate"][e], cfg.act) * (x() @ lp["w_up"][e]))
        out += (gu @ lp["w_down"][e]) * weight[..., e:e + 1]
    if cfg.n_shared_experts:
        gs = _act(x() @ lp["ws_gate"], cfg.act) * (x() @ lp["ws_up"])
        out = out + gs @ lp["ws_down"]
    return out


def moe_excess(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ``||out - ref|| / (2^-6 ||ref||)`` over token rows (the
    module's rule; pass at <= 1). A row of ``ref`` that is all zero counts
    as 0 when ``out``'s equals it and as infinity when not."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).norm(dim=-1)
    allow = ROW_SHARE * r.norm(dim=-1)
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
    return float(ratio.max())


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative L2 of ``a`` against ``b`` over every axis but the first;
    0 where both are zero, infinity where only ``b`` is."""
    a = a.float().reshape(a.shape[0], -1)
    b = b.float().reshape(b.shape[0], -1)
    err, den = (a - b).norm(dim=-1), b.norm(dim=-1)
    return torch.where(err == 0, torch.zeros_like(err), err / den)


def moe_grad_excess(got: dict, want: dict) -> dict:
    """The gradients ``got`` against ``want`` (dicts of ``h`` and layer
    weight names) under the module's gradient rule, leaf by leaf: the
    largest ``relative L2 / 2^-6`` of ``h``'s token rows, of each expert's
    slice of an expert leaf, or of a whole other leaf (pass at <= 1)."""
    out = {}
    for name, r in want.items():
        g = got[name]
        if name == "h":
            out[name] = moe_excess(g, r)
        elif name in EXPERT_LEAVES:
            out[name] = float(_rel_l2(g, r).max()) / ROW_SHARE
        else:
            out[name] = float(_rel_l2(g.reshape(1, -1),
                                      r.reshape(1, -1))[0]) / ROW_SHARE
    return out

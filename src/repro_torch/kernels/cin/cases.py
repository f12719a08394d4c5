"""The cases the CIN kernel is held to its plain version on, the float32
rule it is held by, and a planted fault that the rule must reject.

One table serves the CPU tests (the plain version against the reference's),
the card tests and ``chip_smoke.py`` (the kernel against the plain
version), so that the three cannot drift apart.

The rule scales with each element's own sum of |terms|. For one layer,
``A = cin_layer_ref(|x0|, |xk|, |W|)`` and an output passes when
``|o - r| <= c A`` everywhere, read as ``excess = max |o - r| / (c A)``
(pass at <= 1), with ``c = 2^-16``. Two float32 sums of the same K terms
in any order differ by at most about ``K u A`` (u = 2^-24) and in practice
by a few ``u A``, so a sound kernel reads far below 1 (``c`` is 256 u).
Dropping terms moves an element by their own sum: one ``h`` slice of W
(``m`` of the ``K = H m`` terms, of random signs) moves it by about
``sqrt(m) A / K``, which at m = 39 and K = 7,800 is 8e-4 A, about 50 times
``c A``; so a fault of that size reads far above 1. A tolerance scaled by
the output's own size would not do: the outputs are sums of K signed terms
and near zero for many elements, while their rounding error is set by
``A``.

Stacked layers pass their error on: layer ``k + 1`` scales layer ``k``'s
error by ``|W| |x0|``. So for ``cin()``'s pooled features the allowance is
the same chain run on absolute values, ``A_1 = cin_layer_ref(|x0|, |x0|,
|W_1|)``, ``A_k = cin_layer_ref(|x0|, A_{k-1}, |W_k|)``, each summed over D
(``pooled_magnitude``).

The kernel computes on the tensor cores in 3xTF32: each operand ``x`` is
split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (10 explicit
mantissa bits, rounded to nearest) and ``hi hi + hi lo + lo hi`` is summed
in float32. ``emulated_layer`` repeats that arithmetic in plain PyTorch, so
that the rule's margin under it can be read without the card: the dropped
``lo lo`` and the rounding of ``lo`` leave about ``2^-21`` of each term's
size, 1/32 of ``c``. One pass (``hi hi`` alone) leaves about ``2^-11`` of
each term, which over K = 7,800 terms of random signs is some ``2^-17.5 A``
typically and comes too near ``c A`` at the largest element.

**The gradients** (``GRAD_CASES``; ``TRAIN_CASES`` are the training
batch's layers, checked on the card in chunks of rows). The input
gradients dxk and dx0 are CIN layers themselves, on ``(x0, dy,
W.permute(1, 0, 2))`` and ``(xk, dy, W.permute(2, 0, 1))``, so they are
held to the layer rule above on those operands (``input_grad_operands``):
their K is ``H2 m`` or ``H2 H`` (7,800 or 40,000), and the rule sees a
dropped slice there as it does in the forward. The card computes both in
one launch, reassociated around ``U = dy . W`` (``ref.cin_dx_ref``):
``U`` in 3xTF32 over K = H2, then dx0's sum over h and dxk's over m in
float32 by fused multiply-adds in a fixed order; ``emulated_dx`` repeats
that arithmetic.

dW sums over the batch, K = B D terms (655,360 at the training batch of
65,536), and the layer rule is blind there: the signed sum of K terms of
random signs is about ``sqrt(K)`` times smaller than ``A``, so ``2^-16 A``
is some 10 typical terms at that K, and a kernel that left out one tile
of 128 values of k = (b, d) (about 11 typical terms) would pass. Its rule
scales with the sum's own size instead. With ``S`` the root sum of the
terms' squares (``sqrt(dW of dy^2, xk^2, x0^2)``) and ``r`` the exact
(float64) dW, an element passes when

  |o - r| <= C u sqrt(K) (S + |r|),   u = 2^-24, C = 16

(``dw_excess``; pass at <= 1). A float32 sum's rounding errors are about
``u`` of its running partial sum at each add and take both signs, so
they add up as a random walk: ``sqrt(K) u`` times the partial sums, which
stay below ``S`` where the terms' signs are random and grow to ``|r|``
where they are not. The kernel sums in 3xTF32 on the tensor cores:
each stage of 16 values of k from zero, the stages of a K part
(``kernel.dw_plan``: contiguous ranges of stages, 2 parts of 327,680
terms at the training batch's H-200 layers) in order by float32 adds,
then the parts in order; ``emulated_dw`` repeats that. Measured on the
CPU at ``DW_RULE_CASE`` (B 65,536, K 524,288): 0.0013 under the rule in
the 132 parts of that shape's plan, 0.011 in 2 parts and 0.013 in one.
A dropped tile of 128 terms moves an element by about ``sqrt(128 / K)
S`` (0.016 S there), and reads 67 to 74 (``dw_planted_fault``, at the
first, middle and last tile). The rule assumes what the batch gives: rows
drawn independently, so that no long run of k sums one sign and cancels
later.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.cin.ref import cin_dw_ref, cin_layer_ref

# name -> (B, m, H, H2, D). xdeepfm's layers: m = 39, D = 10, H = 39 (layer
# 1) or 200 (layers 2, 3), H2 = 200; its smoke config: m = 6, D = 8, H = 6
# or 16, H2 = 16. A block holds 128 // D batch rows (12 at D = 10, 16 at
# D = 8), so B = 7, 25 and 37 leave a ragged last block; H2 = 200 leaves a
# last M tile of 8 rows.
CASES = {
    "xdeepfm-layer1-B1": (1, 39, 39, 200, 10),
    "xdeepfm-layer1-B7": (7, 39, 39, 200, 10),
    "xdeepfm-layer2-B7": (7, 39, 200, 200, 10),
    "xdeepfm-layer1-B512": (512, 39, 39, 200, 10),
    "xdeepfm-layer2-B512": (512, 39, 200, 200, 10),
    "ragged-B25-H2-16": (25, 39, 200, 16, 10),
    "m6-H200-D10-B25": (25, 6, 200, 200, 10),
    "smoke-layer1-B7": (7, 6, 6, 16, 8),
    "smoke-layer2-B512": (512, 6, 16, 16, 8),
    "smoke-ragged-B37-H39": (37, 6, 39, 16, 8),
}

# the full-width layer the planted fault is read at (B, m, H, H2, D)
FAULT_CASE = CASES["xdeepfm-layer2-B512"]

RULE_C = 2.0 ** -16
# batch rows per plain call where Z must fit the card (5.1 GB at H = 200)
PLAIN_CHUNK = 16384


def case_inputs(case, seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """x0 [B, m, D], xk [B, H, D] (standard normal) and w [H2, H, m] (normal
    times (H m)^-0.5, the reference's init scale), float32, from ``seed``."""
    B, m, H, H2, D = case
    r = np.random.default_rng([seed, B, m, H, H2, D])
    x0 = r.standard_normal((B, m, D)).astype(np.float32)
    xk = r.standard_normal((B, H, D)).astype(np.float32)
    w = (r.standard_normal((H2, H, m)) * (H * m) ** -0.5).astype(np.float32)
    return x0, xk, w


def excess(out: torch.Tensor, ref: torch.Tensor,
           magnitude: torch.Tensor) -> float:
    """The largest ``|out - ref|`` over its allowance ``c * magnitude``; 1
    or less passes. An element whose allowance is 0 counts as 0 if it equals
    ``ref`` exactly and as infinity if not."""
    if ref.numel() == 0:
        return 0.0
    err = (out - ref).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / (RULE_C * magnitude))
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
    return float(ratio.max())


def layer_excess(out: torch.Tensor, ref: torch.Tensor, x0: torch.Tensor,
                 xk: torch.Tensor, w: torch.Tensor,
                 chunk: int = PLAIN_CHUNK) -> float:
    """``excess`` of one layer's output, with ``A`` computed over the batch
    in chunks of ``chunk`` rows (so its Z fits)."""
    wa = w.abs()
    worst = 0.0
    for i in range(0, ref.shape[0], chunk):
        s = slice(i, i + chunk)
        mag = cin_layer_ref(x0[s].abs(), xk[s].abs(), wa)
        worst = max(worst, excess(out[s], ref[s], mag))
    return worst


def pooled_magnitude(x0: torch.Tensor,
                     weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The allowance of ``cin()``'s pooled features, ``[B, sum(H_k)]``
    (module docstring): the stack run on absolute values."""
    a0 = x0.abs()
    ak = a0
    pooled = []
    for w in weights:
        ak = cin_layer_ref(a0, ak, w.abs())
        pooled.append(ak.sum(dim=-1))
    return torch.cat(pooled, dim=-1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as the kernel's ``cvt.rna.tf32.f32``
    does (to nearest, ties away from zero): half the weight of the 13
    dropped mantissa bits is added to the magnitude bits, which are then
    cut by an int32 mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x's TF32 hi and lo parts, as the kernels split an operand."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def emulated_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                   passes: int = 3) -> torch.Tensor:
    """The layer in the kernel's arithmetic: ``z = xk * x0`` in float32 (the
    reference's product), ``z`` and ``W`` split into TF32 ``hi`` and ``lo``,
    and ``hi hi + hi lo + lo hi`` (``passes=3``, 3xTF32) or ``hi hi`` alone
    (``passes=1``), each product summed in float32."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    zh, zl = _split(torch.einsum("bhd,bmd->bhmd", xk, x0))
    wh, wl = _split(w)
    out = torch.einsum("bhmd,nhm->bnd", zh, wh)
    if passes == 3:
        out = (out + torch.einsum("bhmd,nhm->bnd", zh, wl)
               + torch.einsum("bhmd,nhm->bnd", zl, wh))
    return out


def planted_fault(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                  h: int = 0) -> torch.Tensor:
    """The plain layer as a kernel that skips one ``h`` slice of W would
    compute it: ``m`` of the ``H m`` terms of every output dropped."""
    w = w.clone()
    w[:, h] = 0
    return cin_layer_ref(x0, xk, w)


# The gradients' cases, name -> (B, m, H, H2, D): xdeepfm's layer 1 (39
# filters: dW's last filter pair half empty) and its H-200 layers at
# ragged batches (a ragged last M tile; the dx kernel's N tiles in parts),
# dy of 39 and 6 fields (K = H2 of the dx kernel's U not a multiple of
# 16), fields of 39 and 6 (padded to 40 and 8: the dx kernel's N tiles of
# 200, 16 and 64), the smoke config, and a batch of one stage and less.
GRAD_CASES = {
    "xdeepfm-layer1-B25": (25, 39, 39, 200, 10),
    "xdeepfm-layer2-B37": (37, 39, 200, 200, 10),
    "xdeepfm-layer2-B512": (512, 39, 200, 200, 10),
    "H2-39-B61": (61, 39, 200, 39, 10),
    "H2-6-B9": (9, 6, 16, 6, 8),
    "smoke-layer1-B7": (7, 6, 6, 16, 8),
    "smoke-layer2-B513": (513, 6, 16, 16, 8),
}

# the training batch's layers (B 65,536), card only: their plain Z does not
# fit a CPU test, and the card checks them in chunks of PLAIN_CHUNK rows
TRAIN_CASES = {
    "train-layer1-B65536": (65536, 39, 39, 200, 10),
    "train-layer2-B65536": (65536, 39, 200, 200, 10),
}

# the rule's and the emulation's case on the CPU: the smoke widths at the
# training batch, K = 524,288
DW_RULE_CASE = (65536, 6, 16, 16, 8)

U = 2.0 ** -24
GRAD_RULE_C = 16.0
DW_FAULT_K = 128       # values of k = (b, d) the planted dW fault drops


def grad_case_inputs(case, seed: int = 0):
    """x0, xk and w as ``case_inputs`` gives them, and dy [B, H2, D]
    (standard normal), float32, from ``seed``."""
    x0, xk, w = case_inputs(case, seed)
    B, m, H, H2, D = case
    dy = np.random.default_rng([seed, 1, B, H2, D]).standard_normal(
        (B, H2, D)).astype(np.float32)
    return x0, xk, w, dy


def input_grad_operands(x0, xk, w, dy):
    """The layer operands of which each input gradient is a CIN layer (the
    layer rule's operands):
    ``{"dxk": (x0, dy, W^(1,0,2)), "dx0": (xk, dy, W^(2,0,1))}``, the
    permuted W contiguous (``layer_excess`` takes them as they are)."""
    return {"dxk": (x0, dy, w.permute(1, 0, 2).contiguous()),
            "dx0": (xk, dy, w.permute(2, 0, 1).contiguous())}


def dw_exact(x0: torch.Tensor, xk: torch.Tensor, dy: torch.Tensor,
             chunk: int = PLAIN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r, S)`` of the dW rule: the float64 dW and the root sum of its
    terms' squares, summed over the batch in chunks of ``chunk`` rows."""
    r = s2 = 0
    for i in range(0, x0.shape[0], chunk):
        a, b, c = (t[i:i + chunk].double() for t in (x0, xk, dy))
        r = r + cin_dw_ref(a, b, c)
        s2 = s2 + cin_dw_ref(a * a, b * b, c * c)
    return r, torch.sqrt(s2)


def dw_excess(out: torch.Tensor, r: torch.Tensor, S: torch.Tensor,
              K: int) -> float:
    """The largest ``|out - r|`` over ``C u sqrt(K) (S + |r|)``; 1 or less
    passes (an allowance of 0 as in ``excess``)."""
    err = (out.to(r.device).double() - r).abs()
    allow = GRAD_RULE_C * U * math.sqrt(K) * (S + r.abs())
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
    return float(ratio.max()) if ratio.numel() else 0.0


def dw_planted_fault(x0: torch.Tensor, xk: torch.Tensor, dy: torch.Tensor,
                     k0: int, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """The float64 dW as a kernel that leaves out one tile of
    ``DW_FAULT_K`` values of k = (b, d) from ``k0`` would sum it: dy zeroed
    there."""
    B, H2, D = dy.shape
    k = torch.arange(B * D, device=dy.device).view(B, 1, D)
    keep = ((k < k0) | (k >= k0 + DW_FAULT_K)).to(dy.dtype)
    return dw_exact(x0, xk, dy * keep, chunk)[0]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(a, b, c)``: the product exact in float64, one sum,
    rounded to float32 (a second rounding only where the float64 sum
    itself rounds)."""
    return (a.double() * b.double() + c.double()).float()


def emulated_dx(x0: torch.Tensor, xk: torch.Tensor, dy: torch.Tensor,
                w: torch.Tensor, plan: dict) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(dx0, dxk) in the dx kernel's arithmetic and order, float32:
    ``U[b, h, m, d] = sum_n W dy`` in 3xTF32 (dy and W split into hi and
    lo, ``hi hi + hi lo + lo hi`` summed in float32); dx0 by fused
    multiply-adds of ``xk U`` over h in order within each N part of
    ``plan`` (``kernel.dx_plan``: ``ntn`` tiles of ``ni // mp`` filters in
    ``parts`` parts), the parts' sums added in order; dxk by each quad
    lane's fused multiply-adds of ``x0 U`` over its fields ``mm`` (those
    with ``(mm mod 8) div 2`` its lane) in order, then ``(s0 + s1) + (s2 +
    s3)``."""
    B, m, D = x0.shape
    H = xk.shape[1]
    dh, dl = _split(dy)
    wh, wl = _split(w)
    u = (torch.einsum("bnd,nhm->bhmd", dh, wh)
         + torch.einsum("bnd,nhm->bhmd", dh, wl)
         + torch.einsum("bnd,nhm->bhmd", dl, wh))
    hs, ntn, parts = plan["ni"] // plan["mp"], plan["ntn"], plan["parts"]
    dx0 = None
    for p in range(parts):
        acc = torch.zeros(B, m, D)
        for h in range(ntn * p // parts * hs,
                       min(ntn * (p + 1) // parts * hs, H)):
            acc = _fma(xk[:, h, None, :], u[:, h], acc)
        dx0 = acc if dx0 is None else dx0 + acc
    lanes = []
    for t in range(4):
        acc = torch.zeros(B, H, D)
        for mm in range(m):
            if (mm % 8) // 2 == t:
                acc = _fma(x0[:, None, mm, :], u[:, :, mm, :], acc)
        lanes.append(acc)
    return dx0, (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def emulated_dw(x0: torch.Tensor, xk: torch.Tensor, dy: torch.Tensor,
                parts: int, chunk: int = 4096) -> torch.Tensor:
    """dW [H2, H, m] in the dW kernel's arithmetic and order, float32: ``z
    = xk x0`` (the reference's product) and dy split into TF32 hi and lo;
    over k = (b, d), each stage of 16 values of k summed from zero (``hi
    hi + hi lo + lo hi``, as the tensor cores sum it, here in float32);
    per K part (``parts`` contiguous ranges of stages, as the kernel splits
    them) the stages added in order to a float32 total from zero; then the
    parts' totals added in order. ``chunk`` stages are formed at a time."""
    B, m, D = x0.shape
    H, H2 = xk.shape[1], dy.shape[1]
    K = B * D
    T = -(-K // 16)
    dyk = dy.transpose(1, 2).reshape(K, H2)
    out = None
    for p in range(parts):
        tot = torch.zeros(H2, H * m)
        for s0 in range(T * p // parts, T * (p + 1) // parts, chunk):
            s1 = min(s0 + chunk, T * (p + 1) // parts)
            k0, k1 = 16 * s0, min(16 * s1, K)
            b0, b1 = k0 // D, -(-k1 // D)
            z = (xk[b0:b1, :, None, :] * x0[b0:b1, None, :, :]).permute(
                0, 3, 1, 2).reshape(-1, H * m)[k0 - b0 * D:k1 - b0 * D]
            y = dyk[k0:k1]
            pad = 16 * (s1 - s0) - (k1 - k0)
            if pad:
                z = torch.cat([z, z.new_zeros(pad, H * m)])
                y = torch.cat([y, y.new_zeros(pad, H2)])
            zh, zl = (t.view(s1 - s0, 16, H * m) for t in _split(z))
            yh, yl = (t.view(s1 - s0, 16, H2) for t in _split(y))
            stages = (torch.einsum("skn,skj->snj", yh, zh)
                      + torch.einsum("skn,skj->snj", yl, zh)
                      + torch.einsum("skn,skj->snj", yh, zl))
            # sync: unbinds the stage axis on the card; no element is read
            for st in stages:
                tot += st           # float32, one stage after another
        out = tot if out is None else out + tot
    return out.reshape(H2, H, m)

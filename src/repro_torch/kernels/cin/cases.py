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
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.cin.ref import cin_layer_ref

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


def planted_fault(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                  h: int = 0) -> torch.Tensor:
    """The plain layer as a kernel that skips one ``h`` slice of W would
    compute it: ``m`` of the ``H m`` terms of every output dropped."""
    w = w.clone()
    w[:, h] = 0
    return cin_layer_ref(x0, xk, w)

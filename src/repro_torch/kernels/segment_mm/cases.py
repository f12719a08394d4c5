"""The cases the ``segment_mm`` kernel is held to its plain version on, the
float32 rule it is held by, and two planted faults that the rule must
reject.

One table serves the CPU tests (the plain version against the reference's
``segment_mm_ref`` and its Pallas kernel in interpret mode), the card tests
and ``chip_smoke.py`` (the kernel against the plain version in float64), so
that the three cannot drift apart.

The rule scales with each element's own sum of |terms|,
``A = segment_mm_ref(|x|, src, dst, |coeff|)``, and with the length K of
its row: an output passes when ``|o - r| <= C u sqrt(max(K, 1)) A``
everywhere (u = 2^-24, C = 16), read as ``excess`` (pass at <= 1). Any
float32 order of K terms is within about ``K u A`` of the exact sum, but
a sum's rounding errors take both signs and add up as a random walk: to
about ``sqrt(K) u A`` where the partial sums grow with K (terms of one
sign), and to about ``u A`` where they do not (terms of random signs, as
here). So a sound kernel reads far below 1 (measured on the CPU: at most
0.1 for float32 against float64 on every case). Dropped terms move an
element by their own sum. At a 40,000-edge hub the rule allows
1.9e-4 A; a dropped chunk of 1,024 terms of random signs moves an element
by about 32 typical terms, 32 A / K = 8e-4 A (it reads 11.9 on
``FAULT_CASE``), where the worst-case bound ``K u A`` (2.4e-3 A) would
pass it. A row of average length K that loses one edge moves by about
``A / K``, far above the rule. A tolerance scaled by the output itself
fails where a sum of signed terms is near zero, and one scaled by the
tensor's maximum passes dropped terms of a short row: both are refused
here for the reasons ``kernels/cin/cases.py`` gives.

A chain of layers passes its error on. For a GCN forward the allowance is
the forward run on absolute values (``chain_magnitude``: ``|x|``,
``|W|``, ``|coeff|``, ``|b|``), with K the longest sum on the chain: the
input width of the matmuls or the longest row plus its self term
(``chain_excess``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.segment_mm.ops import CHUNK, csr_layout
from repro_torch.kernels.segment_mm.ref import segment_mm_ref

U = 2.0 ** -24
RULE_C = 16.0

# name -> (kind, N, E, D). "sweep" cases are the reference's own sweep
# (tests/test_kernels.py: uniform endpoints, rng seeded n + d); D = 16 and
# 7 are gcn-cora's widths; D = 128 and 256 take 4 and 8 feature chunks
# per lane. "hub" rows have more than CHUNK in-edges and are split.
CASES: Dict[str, Tuple[str, int, int, int]] = {
    "sweep-100-500-32": ("sweep", 100, 500, 32),
    "sweep-600-2500-64": ("sweep", 600, 2500, 64),
    "sweep-50-2000-128": ("sweep", 50, 2000, 128),
    "sweep-257-513-16": ("sweep", 257, 513, 16),
    "uniform-d7": ("uniform", 300, 3000, 7),
    "uniform-d8": ("uniform", 300, 3000, 8),
    "uniform-d4": ("uniform", 300, 3000, 4),
    "uniform-d1": ("uniform", 40, 200, 1),
    "uniform-d256": ("uniform", 64, 600, 256),
    "no-edges": ("uniform", 10, 0, 16),
    "one-node": ("uniform", 1, 9, 16),
    "duplicates-self-loops": ("duplicates", 64, 2000, 16),
    "empty-rows": ("empty_rows", 1000, 500, 7),
    "row-at-chunk": ("one_long_row", 50, CHUNK, 16),
    "row-past-chunk": ("one_long_row", 50, CHUNK + 1, 16),
    "hub-40000": ("one_long_row", 2000, 40_000, 16),
    "hub-40000-d7": ("one_long_row", 2000, 40_000, 7),
    "hub-5000-d128": ("one_long_row", 300, 5_000, 128),
}

# the case the planted faults are read on: a 40,000-edge hub beside rows
# of a few edges each
FAULT_CASE = "hub-40000"


def case_inputs(name: str, seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray, np.ndarray,
                                                   int]:
    """x [N, D] and coeff [E] (standard normal, float32), src and dst
    (int32 [E]) and N, from ``seed`` (the sweep cases: the reference
    test's own seed, n + d)."""
    kind, n, e, d = CASES[name]
    if kind == "sweep":
        r = np.random.default_rng(n + d)
        src = r.integers(0, n, e).astype(np.int32)
        dst = r.integers(0, n, e).astype(np.int32)
        coeff = r.standard_normal(e).astype(np.float32)
        x = r.standard_normal((n, d)).astype(np.float32)
        return x, src, dst, coeff, n
    r = np.random.default_rng([seed, n, e, d])
    if kind == "uniform":
        src = r.integers(0, n, e)
        dst = r.integers(0, n, e)
    elif kind == "duplicates":
        # 40 distinct (src, dst) pairs repeated, a third of them self-loops
        pairs = r.integers(0, n, (40, 2))
        pairs[::3, 1] = pairs[::3, 0]
        pick = r.integers(0, 40, e)
        src, dst = pairs[pick, 0], pairs[pick, 1]
    elif kind == "empty_rows":
        # every destination in the first tenth of the rows
        src = r.integers(0, n, e)
        dst = r.integers(0, n // 10, e)
    else:  # one_long_row: row 3 takes e edges, and 4 more per other row
        others = 4 * n
        src = r.integers(0, n, e + others)
        dst = np.concatenate([np.full(e, 3), r.integers(0, n, others)])
        dst[e:][dst[e:] == 3] = 4
        order = r.permutation(e + others)
        src, dst = src[order], dst[order]
        e = e + others
    x = r.standard_normal((n, d)).astype(np.float32)
    coeff = r.standard_normal(e).astype(np.float32)
    return x, src.astype(np.int32), dst.astype(np.int32), coeff, n


def in_degree(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    return torch.bincount(dst.to(torch.int64), minlength=n_nodes)


def excess(out: torch.Tensor, ref: torch.Tensor,
           allowance: torch.Tensor) -> float:
    """The largest ``|out - ref|`` over its allowance; 1 or less passes. An
    element whose allowance is 0 counts as 0 if it equals ``ref`` exactly
    and as infinity if not."""
    if ref.numel() == 0:
        return 0.0
    err = (out.double() - ref.double()).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / allowance.double())
    return float(ratio.max())


def rule_excess(out: torch.Tensor, ref: torch.Tensor, x: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor, coeff: torch.Tensor,
                n_nodes: int) -> float:
    """``excess`` of a ``segment_mm`` output under the rule (module
    docstring), with ``A`` and the row lengths from these edges."""
    mag = segment_mm_ref(x.abs(), src, dst, coeff.abs(), n_nodes)
    k = in_degree(dst, n_nodes).clamp_min(1).to(mag.dtype)
    return excess(out, ref, RULE_C * U * k.sqrt()[:, None] * mag)


def chain_magnitude(params: dict, x: torch.Tensor, col: torch.Tensor,
                    row: torch.Tensor, coeff: torch.Tensor,
                    self_coeff: torch.Tensor) -> torch.Tensor:
    """A GCN forward (``models/gnn.gcn_forward``'s layers) on absolute
    values: the allowance of its logits, up to ``chain_excess``'s factor."""
    n = x.shape[0]
    a = x.abs()
    for lp in params["layers"]:
        h = a @ lp["w"].abs()
        a = (segment_mm_ref(h, col, row, coeff.abs(), n)
             + h * self_coeff.abs()[:, None] + lp["b"].abs())
    return a


def chain_excess(out: torch.Tensor, ref: torch.Tensor, magnitude: torch.Tensor,
                 widths: Sequence[int], max_in_degree: int) -> float:
    """``excess`` of a GCN forward's logits: ``C u sqrt(K) M`` with M the
    chain on absolute values and K the longest sum on it, the largest of
    the matmuls' input widths and the longest row plus its self term."""
    k = max(max(widths), max_in_degree + 1)
    return excess(out, ref, RULE_C * U * k ** 0.5 * magnitude)


def _drop(x, src, dst, coeff, n_nodes: int,
          dropped: torch.Tensor) -> torch.Tensor:
    keep = torch.ones_like(dst, dtype=torch.bool)
    keep[dropped] = False
    return segment_mm_ref(x, src[keep], dst[keep], coeff[keep], n_nodes)


def drop_one_edge(x, src, dst, coeff, n_nodes: int) -> torch.Tensor:
    """The plain version as a kernel that skips one edge would compute it:
    the first edge (in the layout's (dst, src) order) of the row whose
    length is nearest the mean length of the non-empty rows."""
    layout = csr_layout(src, dst, n_nodes)
    k = layout.in_degree().double()
    live = k > 0
    gap = torch.where(live, (k - k[live].mean()).abs(),
                      torch.full_like(k, float("inf")))
    first = int(layout.row_ptr[int(torch.argmin(gap))])
    return _drop(x, src, dst, coeff, n_nodes, layout.perm[first:first + 1])


def drop_one_chunk(x, src, dst, coeff, n_nodes: int,
                   chunk: int = CHUNK) -> torch.Tensor:
    """The plain version as a kernel that loses one chunk of a split row
    would compute it: the middle chunk of ``chunk`` edges of the longest
    row (in the layout's (dst, src) order)."""
    layout = csr_layout(src, dst, n_nodes, chunk=chunk)
    k = layout.in_degree()
    r = int(torch.argmax(k))
    n_chunks = -(-int(k[r]) // chunk)
    if n_chunks < 2:
        raise ValueError("drop_one_chunk: the longest row is not split")
    lo = int(layout.row_ptr[r]) + (n_chunks // 2) * chunk
    return _drop(x, src, dst, coeff, n_nodes, layout.perm[lo:lo + chunk])

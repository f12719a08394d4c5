"""Public ``segment_mm`` entry points: the port of the JAX package's
``kernels/segment_mm/ops.py``.

``csr_layout(src, dst, n_nodes)`` is the counterpart of the reference's
``block_edges_for_mm``: it sorts the edges by ``(dst, src)`` in
``np.lexsort((src, dst))``'s order (stable, so equal pairs keep their input
order), on the edges' own device, and returns a destination CSR with the
permutation that reorders per-edge coefficients to match. Build it once per
graph: every layer reuses it. The reference's ``node_tile`` /
``edge_block`` (a TPU tiling into 256-node tiles and 512-edge blocks) have
no counterpart: the CUDA kernel cuts the merged sequence of row ends and
edges into pieces of ``tile`` items instead, and the layout lists the rows
that cross a piece boundary (``crossing_rows``), whose sums the kernel
finishes from per-piece carries.

With ``impl="auto"`` the implementation follows the tensors' device: CUDA
tensors go to the hand-written kernel (``segment_mm_cuda``), which raises
on failure (there is no fallback); CPU tensors go to the plain version
(``segment_mm_ref``). ``impl="ref"`` runs the plain version on any device
(the reference's ``impl="ref"``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.kernels.segment_mm.kernel import TILE, segment_mm_cuda
from repro_torch.kernels.segment_mm.ref import segment_mm_ref

IMPLS = ("auto", "ref")


@dataclass(frozen=True)
class CsrLayout:
    """Edges sorted by (dst, src): row n's in-edges are sorted positions
    ``row_ptr[n] .. row_ptr[n + 1] - 1``. ``crossing_rows`` is derived from
    ``row_ptr`` and ``tile`` on construction (``dataclasses.replace`` with
    another tile derives it again), so the two cannot disagree."""
    n_nodes: int
    row_ptr: torch.Tensor    # int64 [N + 1]
    col: torch.Tensor        # int32 [E], the sorted sources
    row: torch.Tensor        # int32 [E], the sorted destinations
    perm: torch.Tensor       # int64 [E], input position of each sorted edge
    tile: int = TILE         # merged items per piece, in [1, TILE]
    crossing_rows: torch.Tensor = field(init=False)  # int32 [C]

    def __post_init__(self):
        if not 1 <= self.tile <= TILE:
            raise ValueError(f"CsrLayout: tile must be in [1, {TILE}], got "
                             f"{self.tile}")
        object.__setattr__(self, "crossing_rows",
                           crossing_rows(self.row_ptr, self.tile))

    def in_degree(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]


def crossing_rows(row_ptr: torch.Tensor, tile: int) -> torch.Tensor:
    """The rows whose items lie in more than one piece when the merged
    sequence (row r's in-edges at positions ``row_ptr[r] + r ...``, then
    its end at ``row_ptr[r + 1] + r``) is cut into pieces of ``tile``
    items: int32, ascending. Reads their count back (one sync)."""
    n = row_ptr.shape[0] - 1
    r = torch.arange(n, dtype=torch.int64, device=row_ptr.device)
    first = torch.div(row_ptr[:-1] + r, tile, rounding_mode="floor")
    last = torch.div(row_ptr[1:] + r, tile, rounding_mode="floor")
    return torch.nonzero(last > first).flatten().to(torch.int32)


def csr_layout(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
               tile: int = TILE) -> CsrLayout:
    """The destination CSR of edges ``src -> dst`` (int [E], ids in
    ``[0, n_nodes)``), built on their device by one stable sort of the
    64-bit key ``dst * n_nodes + src``, with the rows that cross a boundary
    of pieces of ``tile`` items (at most ``TILE``, the kernel's). Reads the
    id range and the crossing rows back to the host (two syncs per
    graph)."""
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError(f"csr_layout: src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} must be equal 1-d shapes")
    dev = dst.device
    if src.numel():
        lo = min(int(src.min()), int(dst.min()))
        hi = max(int(src.max()), int(dst.max()))
        if lo < 0 or hi >= n_nodes:
            raise ValueError(f"csr_layout: node ids span [{lo}, {hi}], "
                             f"outside [0, {n_nodes})")
    key = dst.to(torch.int64) * n_nodes + src.to(torch.int64)
    _, perm = torch.sort(key, stable=True)
    del key
    row = dst[perm].to(torch.int32)
    col = src[perm].to(torch.int32)
    row_ptr = torch.searchsorted(
        row, torch.arange(n_nodes + 1, dtype=torch.int32, device=dev))
    return CsrLayout(n_nodes, row_ptr, col, row, perm, int(tile))


def segment_mm_csr(x: torch.Tensor, layout: CsrLayout, coeff: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """x [N_src, D], ``coeff`` [E] in the layout's (sorted) order ->
    ``[layout.n_nodes, D]``. ``impl``: auto | ref."""
    if impl not in IMPLS:
        raise ValueError(f"unknown segment_mm impl {impl!r} (expected one "
                         f"of {IMPLS})")
    if impl == "auto" and x.device.type == "cuda":
        return segment_mm_cuda(x, layout, coeff)
    return segment_mm_ref(x, layout.col, layout.row, coeff, layout.n_nodes)


def segment_mm(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               coeff: torch.Tensor, n_nodes: int,
               impl: str = "auto") -> torch.Tensor:
    """Flat edges in any order: x [N_src, D], src / dst int [E], coeff [E]
    -> ``[n_nodes, D]``. On CUDA tensors with ``impl="auto"`` this builds
    the layout on every call; callers that aggregate over one graph more
    than once build it once with ``csr_layout`` and call
    ``segment_mm_csr``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown segment_mm impl {impl!r} (expected one "
                         f"of {IMPLS})")
    if impl == "ref" or x.device.type != "cuda":
        return segment_mm_ref(x, src, dst, coeff, n_nodes)
    layout = csr_layout(src, dst, n_nodes)
    return segment_mm_csr(x, layout, coeff[layout.perm], impl)

"""ctypes wrapper of the hand-written CUDA ``segment_mm``.

``segment_mm_cuda`` (``csrc/segment_mm.cu``) replaces the Pallas kernel
``repro/kernels/segment_mm/kernel.py`` (``_segment_mm_kernel``): over a
destination-sorted CSR (``ops.csr_layout``) it computes
``y[n, :] = sum_e coeff[e] * x[col[e], :]`` for the in-edges of each row n,
in float32, gathering ``x`` itself. The merged sequence of row ends and
edges is cut into pieces of ``layout.tile`` items (``TILE`` by default, the
source's ``kTile``); the rows that cross a piece boundary
(``layout.crossing_rows``) are summed from per-piece carries by a second,
short launch. The library is built with ``nvcc`` for ``sm_90a`` at first
use (``kernels/_build.py``). The wrapper checks shapes, dtypes, strides
and device, allocates the output and the carry buffer, launches
on PyTorch's current stream without synchronising, raises when a launch is
refused (the C entry returns the CUDA error), and adds one to
``.launches`` per call (the fix-up included). It takes float32 only: GCN
runs in float32, and no caller passes another type.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "segment_mm"
SOURCES = ("segment_mm/csrc/segment_mm.cu",)
MAX_D = 256          # 8 feature chunks of 32 lanes
TILE = 2048          # merged items (row ends + edges) per piece: kTile

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES)
    fn = lib.segment_mm_launch
    fn.argtypes = [_P] * 7 + [_LL] * 5 + [_I, _I, _P]
    fn.restype = ctypes.c_int
    return lib


def _reads_whole_chunks(x: torch.Tensor) -> bool:
    """Whether the kernel may read ``x`` in 16-byte chunks: a 16-byte
    aligned base, a row stride that is a multiple of 4 floats, and a read
    of D rounded up to 4 floats from the last row inside ``x``'s storage.
    Any other ``x`` is read a float at a time."""
    n, d = x.shape
    if n == 0 or x.stride(0) % 4 or x.data_ptr() % 16:
        return False
    if x.is_contiguous():
        return True
    end = x.storage_offset() + (n - 1) * x.stride(0) + -(-d // 4) * 4
    return end * 4 <= x.untyped_storage().nbytes()


def segment_mm_cuda(x: torch.Tensor, layout, coeff: torch.Tensor
                    ) -> torch.Tensor:
    """x [N_src, D] float32 with unit column stride and a row stride >= D
    (rows may be padded); ``layout`` an
    ``ops.CsrLayout`` (row_ptr int64, col int32, crossing_rows int32,
    tile); coeff float32 [E] in ``col``'s order; all on one CUDA device
    -> a new ``[N, D]`` float32 tensor."""
    who = "segment_mm_cuda"
    row_ptr, col, cross = layout.row_ptr, layout.col, layout.crossing_rows
    tile = int(layout.tile)
    if x.dim() != 2 or row_ptr.dim() != 1 or col.dim() != 1 \
            or coeff.dim() != 1 or cross.dim() != 1:
        raise ValueError(f"{who}: x must be 2-d [N_src, D] and row_ptr, "
                         f"col, coeff, crossing_rows 1-d")
    D = x.shape[1]
    n_rows = row_ptr.shape[0] - 1
    if n_rows < 0 or col.shape[0] != coeff.shape[0] \
            or cross.shape[0] > max(n_rows, 0):
        raise ValueError(f"{who}: shapes row_ptr {tuple(row_ptr.shape)}, "
                         f"col {tuple(col.shape)}, coeff "
                         f"{tuple(coeff.shape)}, crossing_rows "
                         f"{tuple(cross.shape)} do not agree")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{who}: needs 1 <= D <= {MAX_D}, got D={D}")
    if not 1 <= tile <= TILE:
        raise ValueError(f"{who}: layout tile must be in [1, {TILE}], got "
                         f"{tile}")
    for name, t, want in (("x", x, torch.float32),
                          ("row_ptr", row_ptr, torch.int64),
                          ("col", col, torch.int32),
                          ("coeff", coeff, torch.float32),
                          ("crossing_rows", cross, torch.int32)):
        if t.dtype != want:
            raise ValueError(f"{who}: {name} must be {want}, got {t.dtype}")
        if t is not x and not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous, got "
                             f"strides {t.stride()}")
    if (D > 1 and x.stride(1) != 1) or x.stride(0) < D:
        raise ValueError(f"{who}: x needs unit column stride and a row "
                         f"stride >= D (rows may be padded), got strides "
                         f"{x.stride()}")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (row_ptr, col, coeff, cross)):
        raise ValueError(f"{who}: x, row_ptr, col, coeff and crossing_rows "
                         f"must be on one CUDA device, got {x.device}, "
                         f"{row_ptr.device}, {col.device}, {coeff.device}, "
                         f"{cross.device}")
    y = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
    if n_rows == 0:
        return y
    n_edges = col.shape[0]
    n_pieces = -(-(n_rows + n_edges) // tile)
    carry = torch.empty(2 * n_pieces * (-(-D // 4) * 4),
                        dtype=torch.float32, device=dev)
    fn = load_library().segment_mm_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(row_ptr.data_ptr(), col.data_ptr(), coeff.data_ptr(),
             x.data_ptr(), cross.data_ptr(), y.data_ptr(), carry.data_ptr(),
             n_rows, n_edges, x.stride(0), cross.shape[0], tile, D,
             int(_reads_whole_chunks(x)), stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    segment_mm_cuda.launches += 1
    return y


segment_mm_cuda.launches = 0

"""ctypes wrapper of the hand-written CUDA ``segment_mm``.

``segment_mm_cuda`` (``csrc/segment_mm.cu``) replaces the Pallas kernel
``repro/kernels/segment_mm/kernel.py`` (``_segment_mm_kernel``): over a
destination-sorted CSR (``ops.csr_layout``) it computes
``y[n, :] = sum_e coeff[e] * x[col[e], :]`` for the in-edges of each row n,
in float32, gathering ``x`` itself, with rows longer than ``chunk`` edges
split across the warps of one block. The library is built with ``nvcc``
for ``sm_90a`` at first use (``kernels/_build.py``). The wrapper checks
shapes, dtypes, contiguity and device, allocates the output, launches on
PyTorch's current stream without synchronising, raises when the launch is
refused (the C entry returns the CUDA error), and adds one to
``.launches``. It takes float32 only: GCN runs in float32, and no caller
passes another type.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "segment_mm"
SOURCES = ("segment_mm/csrc/segment_mm.cu",)
MAX_D = 256          # 8 feature chunks of 32 lanes

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES)
    fn = lib.segment_mm_launch
    fn.argtypes = [_P] * 6 + [_LL, _LL, _I, _I, _P]
    fn.restype = ctypes.c_int
    return lib


def segment_mm_cuda(x: torch.Tensor, row_ptr: torch.Tensor,
                    col: torch.Tensor, coeff: torch.Tensor,
                    long_rows: torch.Tensor, chunk: int) -> torch.Tensor:
    """x [N_src, D] float32, row_ptr int64 [N + 1], col int32 [E], coeff
    float32 [E] (in ``col``'s order) and long_rows int32 (the rows with more
    than ``chunk`` in-edges), contiguous on one CUDA device -> a new
    ``[N, D]`` float32 tensor."""
    who = "segment_mm_cuda"
    if x.dim() != 2 or row_ptr.dim() != 1 or col.dim() != 1 \
            or coeff.dim() != 1 or long_rows.dim() != 1:
        raise ValueError(f"{who}: x must be 2-d [N_src, D] and row_ptr, "
                         f"col, coeff, long_rows 1-d")
    D = x.shape[1]
    n_rows = row_ptr.shape[0] - 1
    if n_rows < 0 or col.shape[0] != coeff.shape[0] \
            or long_rows.shape[0] > max(n_rows, 0):
        raise ValueError(f"{who}: shapes row_ptr {tuple(row_ptr.shape)}, "
                         f"col {tuple(col.shape)}, coeff "
                         f"{tuple(coeff.shape)}, long_rows "
                         f"{tuple(long_rows.shape)} do not agree")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{who}: needs 1 <= D <= {MAX_D}, got D={D}")
    if int(chunk) < 1:
        raise ValueError(f"{who}: chunk must be >= 1, got {chunk}")
    for name, t, want in (("x", x, torch.float32),
                          ("row_ptr", row_ptr, torch.int64),
                          ("col", col, torch.int32),
                          ("coeff", coeff, torch.float32),
                          ("long_rows", long_rows, torch.int32)):
        if t.dtype != want:
            raise ValueError(f"{who}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous, got "
                             f"strides {t.stride()}")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (row_ptr, col, coeff, long_rows)):
        raise ValueError(f"{who}: x, row_ptr, col, coeff and long_rows must "
                         f"be on one CUDA device, got {x.device}, "
                         f"{row_ptr.device}, {col.device}, {coeff.device}, "
                         f"{long_rows.device}")
    y = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
    if n_rows == 0:
        return y
    fn = load_library().segment_mm_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(row_ptr.data_ptr(), col.data_ptr(), coeff.data_ptr(),
             x.data_ptr(), long_rows.data_ptr(), y.data_ptr(), n_rows,
             int(chunk), long_rows.shape[0], D, stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    segment_mm_cuda.launches += 1
    return y


segment_mm_cuda.launches = 0

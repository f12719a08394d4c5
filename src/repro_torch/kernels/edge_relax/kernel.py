"""ctypes wrapper of the CUDA edge-relax kernel (``csrc/edge_relax.cu``).

Replaces the Pallas kernel ``repro/kernels/edge_relax/kernel.py``
(``_relax_kernel``). The library is built with ``nvcc`` for ``sm_90a`` at
first use (``kernels/_build.py``). The wrapper checks device, dtype, shape
and contiguity, allocates the three output planes, launches on PyTorch's
current stream without synchronising, raises when ``cudaGetLastError()``
reports a refused launch, and adds one to ``edge_relax_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

NAME = "edge_relax"
SOURCES = ("edge_relax/csrc/edge_relax.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES)
    fn = lib.edge_relax_launch
    fn.argtypes = [_P] * 9 + [_I, _I] + [_P] * 4
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, length: int, device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"edge_relax_cuda: {name} must be on {device}, "
                         f"got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"edge_relax_cuda: {name} must be int32, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != length:
        raise ValueError(f"edge_relax_cuda: {name} must have shape "
                         f"[{length}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"edge_relax_cuda: {name} must be contiguous")


def edge_relax_cuda(
    planes: Sequence[torch.Tensor],   # (d, c, p, rw0, rc, rp), int32 [n]
    row_ptr: torch.Tensor,            # int32 [n+1], dst-sorted CSR
    src: torch.Tensor,                # int32 [E]
    w: torch.Tensor,                  # int32 [E]
    delta: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One relax superstep on the card. Returns (d_min, c_min, p_min)."""
    n = row_ptr.shape[0] - 1
    e = src.shape[0]
    dev = row_ptr.device
    _check("row_ptr", row_ptr, n + 1, dev)
    _check("src", src, e, dev)
    _check("w", w, e, dev)
    for name, t in zip(("d", "c", "p", "rw0", "rc", "rp"), planes):
        _check(name, t, n, dev)
    delta = int(delta)
    if not 1 <= delta <= 2**30:
        raise ValueError(f"edge_relax_cuda: delta must be in [1, 2^30], "
                         f"got {delta}")
    fn = load_library().edge_relax_launch
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(row_ptr.data_ptr(), src.data_ptr(), w.data_ptr(),
             *[t.data_ptr() for t in planes], delta, n,
             *[t.data_ptr() for t in out], stream)
    if err != 0:
        raise RuntimeError(f"edge_relax_cuda: launch failed with CUDA error "
                           f"{err}")
    edge_relax_cuda.launches += 1
    return out[0], out[1], out[2]


edge_relax_cuda.launches = 0

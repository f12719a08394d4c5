"""ctypes wrapper of the hand-written CUDA CIN layer.

``cin_layer_cuda`` (``csrc/cin.cu``) replaces the Pallas kernel
``repro/kernels/cin/kernel.py`` (``_cin_kernel``): one CIN layer
``out[b, n, d] = sum_{h, m} W[n, h, m] xk[b, h, d] x0[b, m, d]`` in float32,
on the tensor cores in 3xTF32 (``wgmma``), without the outer product ever
reaching device memory. The library is built with ``nvcc`` for ``sm_90a``
at first use (``kernels/_build.py``). The wrapper checks shapes, dtype,
strides and device, allocates the output and the scratch the C entry asks
for (W split into its TF32 parts; partial outputs when K is split to fill
the card), launches on PyTorch's current stream without synchronising,
raises when the launch is refused (the C entry returns the CUDA error),
and adds one to ``.launches``. It takes float32 in the reference's
layouts only: no caller passes another type, so there is no bf16 path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "cin"
SOURCES = ("cin/csrc/cin.cu",)
MAX_FIELDS = 128       # m: the staged x0 rows and 3 W stages fit 227 KB
MAX_EMBED_DIM = 128    # D: the wrapper's limit since the first kernel

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES)
    fn = lib.cin_layer_launch
    fn.argtypes = [_P] * 6 + [ctypes.c_longlong] + [_I] * 4 + [_P]
    fn.restype = ctypes.c_int
    ws = lib.cin_layer_workspace
    ws.argtypes = [ctypes.c_longlong] + [_I] * 4 + [_P]
    ws.restype = ctypes.c_int
    return lib


def cin_layer_cuda(x0: torch.Tensor, xk: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m], contiguous float32 on one
    CUDA device -> a new ``[B, H2, D]`` float32 tensor."""
    who = "cin_layer_cuda"
    if x0.dim() != 3 or xk.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{who}: x0, xk and w must be 3-d ([B, m, D], "
                         f"[B, H, D], [H2, H, m])")
    B, m, D = x0.shape
    H, H2 = xk.shape[1], w.shape[0]
    if xk.shape[0] != B or xk.shape[2] != D or tuple(w.shape[1:]) != (H, m):
        raise ValueError(f"{who}: shapes x0 {tuple(x0.shape)}, xk "
                         f"{tuple(xk.shape)}, w {tuple(w.shape)} do not agree")
    if not (1 <= m <= MAX_FIELDS and 1 <= D <= MAX_EMBED_DIM
            and H >= 1 and H2 >= 1):
        raise ValueError(f"{who}: needs 1 <= m <= {MAX_FIELDS}, 1 <= D <= "
                         f"{MAX_EMBED_DIM}, H >= 1 and H2 >= 1; got m={m}, "
                         f"D={D}, H={H}, H2={H2}")
    if x0.dtype != torch.float32 or xk.dtype != torch.float32 \
            or w.dtype != torch.float32:
        raise ValueError(f"{who}: x0, xk and w must be float32, got "
                         f"{x0.dtype}, {xk.dtype}, {w.dtype}")
    for name, t in (("x0", x0), ("xk", xk), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous, got strides "
                             f"{t.stride()}")
    dev = x0.device
    if dev.type != "cuda" or xk.device != dev or w.device != dev:
        raise ValueError(f"{who}: x0, xk and w must be on one CUDA device, "
                         f"got {x0.device}, {xk.device}, {w.device}")
    out = torch.empty((B, H2, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = load_library()
    sizes = (ctypes.c_longlong * 2)()
    err = lib.cin_layer_workspace(B, m, H, H2, D, sizes)
    if err != 0:
        raise RuntimeError(f"{who}: workspace query failed with CUDA error "
                           f"{err}")
    ws = torch.empty(sizes[0], dtype=torch.float32, device=dev)
    part = torch.empty(sizes[1], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cin_layer_launch(x0.data_ptr(), xk.data_ptr(), w.data_ptr(),
                               out.data_ptr(), ws.data_ptr(),
                               part.data_ptr(), B, m, H, H2, D, stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    cin_layer_cuda.launches += 1
    return out


cin_layer_cuda.launches = 0

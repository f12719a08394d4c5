"""ctypes wrapper of the hand-written CUDA flash attention forward.

``flash_attention_cuda`` (``csrc/flash_attention.cu``) replaces the Pallas
kernel ``repro/kernels/flash_attention/kernel.py`` (``_flash_kernel``):
bf16 inputs take the warp-specialised ``wgmma`` kernel (K and V staged by
TMA), at a head dim of 16, 32, 64, 128 or 256; float32 inputs (the tests'
precision) the warp-per-row kernel, at any head dim that is a multiple of 8
up to 256. The library is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``), linked with the driver library for the TMA tensor
maps it encodes on each launch. The wrapper
checks device, dtype, shapes, strides and alignment, allocates the output,
launches on PyTorch's current stream without synchronising, raises when
the launch is refused (the C entry returns the CUDA error), and adds one
to ``.launches``.

The kernel masks the ragged edges itself, so the caller pads nothing.
``kv_len`` and ``q_offset`` may be Python ints or int32 device tensors
(``kv_len`` ``[]`` or ``[B]``); the kernel reads them on the device, so a
tensor costs no host read.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import IntLike

NAME = "flash_attention"
SOURCES = ("flash_attention/csrc/flash_attention.cu",)
EXTRA_FLAGS = ("-lcuda",)   # cuTensorMapEncodeTiled
MAX_HEAD_DIM = 256
BF16_HEAD_DIMS = (16, 32, 64, 128, 256)   # the tensor-core instantiations
Q_TILE = 128    # query rows per block of the tensor-core kernel
KV_TILE = 64    # keys per kv tile (one stage of its ring)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES, EXTRA_FLAGS)
    fn = lib.flash_attention_launch
    fn.argtypes = ([_P] * 5 + [_I, _P] + [_I] * 6 + [_P] + [_I, _I]
                   + [ctypes.c_float, ctypes.c_float, _I, _P])
    fn.restype = ctypes.c_int
    return lib


def _device_int32(x: IntLike, default: int, length: int, name: str,
                  dev: torch.device) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor on ``dev``: ``[1]`` for a scalar,
    or ``[length]``. A Python int becomes a device fill (no host copy)."""
    x = default if x is None else x
    if isinstance(x, int):
        return torch.full((1,), x, dtype=torch.int32, device=dev)
    t = torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1)
    if t.numel() not in (1, length):
        raise ValueError(f"flash_attention_cuda: {name} must be [] or "
                         f"[{length}], got {t.numel()} values")
    return t.contiguous()


def flash_attention_cuda(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, D]
    kv_len: IntLike = None,     # [] or [B]; default Skv
    q_offset: IntLike = None,   # []; default 0
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward on the card; returns ``[B, Hq, Sq, D]`` in q's
    dtype (a new contiguous tensor)."""
    who = "flash_attention_cuda"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{who}: q, k, v must be 4-d [B, H, S, D]")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"{who}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{who}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{who}: q, k, v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{who}: q, k, v must all be bfloat16 or float32, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < D <= MAX_HEAD_DIM or D % 8:
        raise ValueError(f"{who}: head dim must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}], got {D}")
    if q.dtype == torch.bfloat16 and D not in BF16_HEAD_DIMS:
        raise ValueError(f"{who}: bf16 head dim must be one of "
                         f"{BF16_HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{who}: {name} must be contiguous in its last "
                             f"dim")
        # TMA wants a 16-byte aligned base and 16-byte multiples as strides
        if t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{who}: {name} must be 16-byte aligned with "
                             f"strides that are multiples of 8 elements")
    if window < 0 or softcap < 0:
        raise ValueError(f"{who}: window and softcap must be >= 0")
    scale = float(scale if scale is not None else D ** -0.5)
    kvl = _device_int32(kv_len, Skv, B, "kv_len", dev)
    qoff = _device_int32(q_offset, 0, 1, "q_offset", dev)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = load_library().flash_attention_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             kvl.data_ptr(), 1 if kvl.numel() > 1 else 0, qoff.data_ptr(),
             B, Hq, Hkv, Sq, Skv, D, strides, int(bool(causal)), int(window),
             float(softcap), scale, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0

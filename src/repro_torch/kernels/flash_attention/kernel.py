"""ctypes wrappers of the hand-written CUDA flash attention forward and
backward.

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

With ``return_lse=True`` the forward also writes each query row's
log-sum-exp (float32 ``[B, Hq, Sq]``, ``m + log(l)`` in natural-log units,
``-1e30`` for a row with no valid key), the residual the backward reads.

``flash_attention_bwd_cuda`` (no TPU kernel: the reference trains through
the jnp custom VJP of ``attention_mef``, ``ops.py:189-245``) computes
``(dq, dk, dv)`` from ``q, k, v, o, lse`` and ``do`` in three launches
(``csrc/flash_attention.cu``): ``flash_bwd_delta`` (delta and lse in log2
units, rows padded to ``BWD_ROW_PAD``), ``flash_bwd_dkdv_wgmma`` (a block
per ``BWD_BLOCK_ROWS[D]`` keys walks the 64-row query tiles that see them)
and ``flash_bwd_dq_wgmma`` (a block per ``BWD_BLOCK_ROWS[D]`` query rows
walks their 64-key tiles), warp-specialised ``wgmma`` kernels fed by TMA
under mbarriers like the forward, no atomics; bf16 at a head dim of
128 or 256. It adds one to ``.launches`` per call (not per launch).

The kernels mask the ragged edges themselves, so the caller pads nothing.
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
BWD_HEAD_DIMS = (128, 256)                # the backward's instantiations
Q_TILE = 128    # query rows per block of the tensor-core kernel
KV_TILE = 64    # keys per kv tile (one stage of its ring)
BWD_STAGE_ROWS = 64   # queries a dK/dV stage, keys a dQ stage (inner loops)
BWD_BLOCK_ROWS = {128: 128, 256: 64}   # keys a dK/dV block, query rows a
                                       # dQ block (outer tiles), by head dim
BWD_ROW_PAD = 128     # the backward's lse and delta rows: a multiple of this

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES, EXTRA_FLAGS)
    fn = lib.flash_attention_launch
    fn.argtypes = ([_P] * 6 + [_I, _P] + [_I] * 6 + [_P] + [_I, _I]
                   + [ctypes.c_float, ctypes.c_float, _I, _P])
    fn.restype = ctypes.c_int
    bwd = lib.flash_attention_bwd_launch
    bwd.argtypes = ([_P] * 11 + [_I, _P] + [_I] * 6 + [_P] + [_I, _I]
                    + [ctypes.c_float, ctypes.c_float, _I, _P])
    bwd.restype = ctypes.c_int
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


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t`` as it lies: TMA (and the backward's
    16-byte copies) want a unit last stride, a 16-byte aligned base and
    strides of whole 16-byte rows (multiples of 8 elements)."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _check_tma_operand(who: str, name: str, t: torch.Tensor) -> None:
    if not tma_ready(t):
        raise ValueError(f"{who}: {name} must be contiguous in its last dim "
                         f"and 16-byte aligned with strides that are "
                         f"multiples of 8 elements")


def _check_qkv(who: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tma_operand(who, name, t)


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
    return_lse: bool = False,
):
    """Attention forward on the card; returns ``[B, Hq, Sq, D]`` in q's
    dtype (a new contiguous tensor), and with ``return_lse`` also the
    float32 ``[B, Hq, Sq]`` log-sum-exp: ``(o, lse)``."""
    who = "flash_attention_cuda"
    _check_qkv(who, q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and D not in BF16_HEAD_DIMS:
        raise ValueError(f"{who}: bf16 head dim must be one of "
                         f"{BF16_HEAD_DIMS}, got {D}")
    if window < 0 or softcap < 0:
        raise ValueError(f"{who}: window and softcap must be >= 0")
    dev = q.device
    scale = float(scale if scale is not None else D ** -0.5)
    kvl = _device_int32(kv_len, Skv, B, "kv_len", dev)
    qoff = _device_int32(q_offset, 0, 1, "q_offset", dev)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = load_library().flash_attention_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             kvl.data_ptr(), 1 if kvl.numel() > 1 else 0, qoff.data_ptr(),
             B, Hq, Hkv, Sq, Skv, D, strides, int(bool(causal)), int(window),
             float(softcap), scale, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


BWD_DELTA, BWD_DKDV, BWD_DQ = 1, 2, 4   # the backward's launches (bits)
BWD_ALL = BWD_DELTA | BWD_DKDV | BWD_DQ


def flash_attention_bwd_launcher(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, D]
    o: torch.Tensor,            # [B, Hq, Sq, D]: the forward's output
    lse: torch.Tensor,          # float32 [B, Hq, Sq]: the forward's lse
    do: torch.Tensor,           # [B, Hq, Sq, D]: the output's gradient
    kv_len: IntLike = None,
    q_offset: IntLike = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
):
    """Checks the backward's operands and allocates its outputs and scratch
    once; returns ``(run, (dq, dk, dv))``, where ``run(parts)`` launches
    the chosen launches (``BWD_DELTA | BWD_DKDV | BWD_DQ``, in that order)
    on those buffers. ``flash_attention_bwd_cuda`` runs all three; a run
    of one alone (after a run of the delta launch) times that launch."""
    who = "flash_attention_bwd_cuda"
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{who}: the backward takes bfloat16, got {q.dtype}")
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"{who}: head dim must be one of {BWD_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    _check_qkv(who, q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, Hq, Sq, D) or t.dtype != q.dtype \
                or t.device != dev:
            raise ValueError(f"{who}: {name} must be {q.dtype} "
                             f"{(B, Hq, Sq, D)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        _check_tma_operand(who, name, t)
    if tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"{who}: lse must be a contiguous float32 "
                         f"{(B, Hq, Sq)} on {dev}")
    if window < 0 or softcap < 0:
        raise ValueError(f"{who}: window and softcap must be >= 0")
    scale = float(scale if scale is not None else D ** -0.5)
    kvl = _device_int32(kv_len, Skv, B, "kv_len", dev)
    qoff = _device_int32(q_offset, 0, 1, "q_offset", dev)
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Hkv, Skv, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Hkv, Skv, D), dtype=q.dtype, device=dev)
    sqp = -(-Sq // BWD_ROW_PAD) * BWD_ROW_PAD
    rows = torch.empty((2, B, Hq, sqp), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3])
    fn = load_library().flash_attention_bwd_launch
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(parts: int) -> None:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), rows.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), kvl.data_ptr(),
                 1 if kvl.numel() > 1 else 0, qoff.data_ptr(), B, Hq, Hkv,
                 Sq, Skv, D, strides, int(bool(causal)), int(window),
                 float(softcap), scale, int(parts), stream)
        if err != 0:
            raise RuntimeError(f"{who}: launch failed with CUDA error {err}")

    return run, (dq, dk, dv)


def flash_attention_bwd_cuda(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, D]
    o: torch.Tensor,            # [B, Hq, Sq, D]: the forward's output
    lse: torch.Tensor,          # float32 [B, Hq, Sq]: the forward's lse
    do: torch.Tensor,           # [B, Hq, Sq, D]: the output's gradient
    kv_len: IntLike = None,
    q_offset: IntLike = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
):
    """The attention backward on the card: ``(dq, dk, dv)``, new contiguous
    bf16 tensors of q's, k's and v's shapes. The mask arguments must be
    the forward's. bf16 only, at a head dim of 128 or 256."""
    run, grads = flash_attention_bwd_launcher(
        q, k, v, o, lse, do, kv_len=kv_len, q_offset=q_offset, causal=causal,
        window=window, softcap=softcap, scale=scale)
    run(BWD_ALL)
    flash_attention_bwd_cuda.launches += 1
    return grads


flash_attention_bwd_cuda.launches = 0

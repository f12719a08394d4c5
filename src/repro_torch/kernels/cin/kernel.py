"""ctypes wrappers of the hand-written CUDA CIN layer and its gradients.

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

The layer's gradients (``kernels/cin/ref.py`` has their plain versions),
each counted apart on its own wrapper:
  * ``cin_dxk_cuda(x0, dy, w)`` and ``cin_dx0_cuda(xk, dy, w)``: the input
    gradients are CIN layers themselves, so each is one launch of the
    same kernel, on ``(x0, dy, W.permute(1, 0, 2))`` and ``(xk, dy,
    W.permute(2, 0, 1))`` (the permuted W copied contiguous: 1.56 M floats
    at xdeepfm's widths). dX0 stages xk's H rows where the forward stages
    x0's m, so the field limit is the shared memory's, as the C entry
    ``cin_layer_max_fields`` works it out on the current device (on an
    H100, 136 rows beside an output of more than 64, 312 beside 64 or
    fewer; dX0's output is m = 39 wide).
  * ``cin_dw_cuda(x0, xk, dy)``: the filters' gradient, a sum over the
    batch (``cin_dw_fma``: float32 FMA, the batch split into ``dw_parts``
    K parts summed in a fixed order).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "cin"
SOURCES = ("cin/csrc/cin.cu",)
MAX_EMBED_DIM = 128    # D: the wrapper's limit since the first kernel
DW_TILE = 128          # n and (h, m) of a dW block (cin.cu's kDwTile)
DW_BLOCKS = 264        # the dW blocks the K parts aim at: 2 per SM

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C
    entries."""
    lib = _build.load(NAME, SOURCES)
    fn = lib.cin_layer_launch
    fn.argtypes = [_P] * 6 + [_L] + [_I] * 4 + [_P]
    fn.restype = ctypes.c_int
    ws = lib.cin_layer_workspace
    ws.argtypes = [_L] + [_I] * 4 + [_P]
    ws.restype = ctypes.c_int
    mf = lib.cin_layer_max_fields
    mf.argtypes = [_I, _P]
    mf.restype = ctypes.c_int
    dw = lib.cin_dw_launch
    dw.argtypes = [_P] * 5 + [_L] + [_I] * 5 + [_P]
    dw.restype = ctypes.c_int
    return lib


def max_fields(H2: int) -> int:
    """The most staged rows m a layer launch beside an output of H2 fields
    takes on the current CUDA device (the C entry works it out from the
    launch's shared memory and the card's limit)."""
    m = ctypes.c_int(0)
    err = load_library().cin_layer_max_fields(H2, ctypes.byref(m))
    if err != 0:
        raise RuntimeError(f"cin_layer_max_fields failed with CUDA error "
                           f"{err}")
    return m.value


def dw_parts(B: int, m: int, H: int, H2: int) -> int:
    """K parts of the dW kernel: as many as keep its blocks at or under
    ``DW_BLOCKS`` (one at least, one batch row each at most). A function of
    the shapes alone, so two launches sum in the same order."""
    tiles = -(-H * m // DW_TILE) * -(-H2 // DW_TILE)
    return max(1, min(DW_BLOCKS // tiles, B))


def _check(who: str, names, x0, xk, w_or_dy, agree: bool) -> None:
    """The three operands 3-d, of shapes that agree (``agree``, worked out
    by the caller), float32, contiguous, on one CUDA device; D within the
    limit."""
    ops = (x0, xk, w_or_dy)
    if any(t.dim() != 3 for t in ops):
        raise ValueError(f"{who}: {', '.join(names)} must be 3-d")
    if not agree:
        shapes = ", ".join(f"{n} {tuple(t.shape)}"
                           for n, t in zip(names, ops))
        raise ValueError(f"{who}: shapes {shapes} do not agree")
    D = x0.shape[2]
    if not 1 <= D <= MAX_EMBED_DIM:
        raise ValueError(f"{who}: needs 1 <= D <= {MAX_EMBED_DIM}, got "
                         f"D={D}")
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError(f"{who}: {', '.join(names)} must be float32, got "
                         f"{x0.dtype}, {xk.dtype}, {w_or_dy.dtype}")
    for name, t in zip(names, ops):
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous, got strides "
                             f"{t.stride()}")
    dev = x0.device
    if dev.type != "cuda" or xk.device != dev or w_or_dy.device != dev:
        raise ValueError(f"{who}: {', '.join(names)} must be on one CUDA "
                         f"device, got {x0.device}, {xk.device}, "
                         f"{w_or_dy.device}")


def _layer(who: str, x0: torch.Tensor, xk: torch.Tensor,
           w: torch.Tensor) -> torch.Tensor:
    """One launch of the layer kernel on checked operands -> ``[B, H2,
    D]``; counts nothing."""
    B, m, D = x0.shape
    H, H2 = xk.shape[1], w.shape[0]
    if min(m, H, H2) < 1:
        raise ValueError(f"{who}: needs m, H and H2 >= 1; got m={m}, H={H}, "
                         f"H2={H2}")
    most = max_fields(H2)
    if m > most:
        raise ValueError(f"{who}: needs m <= {most} (the staged rows beside "
                         f"an output of {H2} in shared memory); got m={m}")
    dev = x0.device
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
    return out


def cin_layer_cuda(x0: torch.Tensor, xk: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m], contiguous float32 on one
    CUDA device -> a new ``[B, H2, D]`` float32 tensor."""
    who = "cin_layer_cuda"
    agree = (x0.dim() == xk.dim() == w.dim() == 3
             and xk.shape[0] == x0.shape[0] and xk.shape[2] == x0.shape[2]
             and tuple(w.shape[1:]) == (xk.shape[1], x0.shape[1]))
    _check(who, ("x0", "xk", "w"), x0, xk, w, agree)
    out = _layer(who, x0, xk, w)
    if x0.shape[0]:
        cin_layer_cuda.launches += 1
    return out


def cin_dxk_cuda(x0: torch.Tensor, dy: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """dxk [B, H, D] of a layer on x0 [B, m, D] with filters w [H2, H, m],
    for dy [B, H2, D]: the layer kernel on ``(x0, dy, W.permute(1, 0,
    2))``."""
    who = "cin_dxk_cuda"
    agree = (x0.dim() == dy.dim() == w.dim() == 3
             and dy.shape[0] == x0.shape[0] and dy.shape[2] == x0.shape[2]
             and w.shape[0] == dy.shape[1] and w.shape[2] == x0.shape[1])
    _check(who, ("x0", "dy", "w"), x0, dy, w, agree)
    out = _layer(who, x0, dy, w.permute(1, 0, 2).contiguous())
    if x0.shape[0]:
        cin_dxk_cuda.launches += 1
    return out


def cin_dx0_cuda(xk: torch.Tensor, dy: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """dx0 [B, m, D] of a layer on xk [B, H, D] with filters w [H2, H, m],
    for dy [B, H2, D]: the layer kernel on ``(xk, dy, W.permute(2, 0,
    1))``, xk's H rows staged where the forward stages x0's."""
    who = "cin_dx0_cuda"
    agree = (xk.dim() == dy.dim() == w.dim() == 3
             and dy.shape[0] == xk.shape[0] and dy.shape[2] == xk.shape[2]
             and w.shape[0] == dy.shape[1] and w.shape[1] == xk.shape[1])
    _check(who, ("xk", "dy", "w"), xk, dy, w, agree)
    out = _layer(who, xk, dy, w.permute(2, 0, 1).contiguous())
    if xk.shape[0]:
        cin_dx0_cuda.launches += 1
    return out


def cin_dw_cuda(x0: torch.Tensor, xk: torch.Tensor,
                dy: torch.Tensor) -> torch.Tensor:
    """dW [H2, H, m] of a layer on x0 [B, m, D] and xk [B, H, D], for dy
    [B, H2, D], contiguous float32 on one CUDA device: ``cin_dw_fma`` in
    ``dw_parts`` K parts (their partial outputs allocated here), summed in
    order. B = 0 gives zeros and launches nothing."""
    who = "cin_dw_cuda"
    agree = (x0.dim() == xk.dim() == dy.dim() == 3
             and xk.shape[0] == x0.shape[0] == dy.shape[0]
             and xk.shape[2] == x0.shape[2] == dy.shape[2])
    _check(who, ("x0", "xk", "dy"), x0, xk, dy, agree)
    B, m, D = x0.shape
    H, H2 = xk.shape[1], dy.shape[1]
    if min(m, H, H2) < 1:
        raise ValueError(f"{who}: needs m, H and H2 >= 1; got m={m}, H={H}, "
                         f"H2={H2}")
    dev = x0.device
    if B == 0:
        return torch.zeros((H2, H, m), dtype=torch.float32, device=dev)
    out = torch.empty((H2, H, m), dtype=torch.float32, device=dev)
    parts = dw_parts(B, m, H, H2)
    part = torch.empty(parts * H2 * H * m if parts > 1 else 0,
                       dtype=torch.float32, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cin_dw_launch(x0.data_ptr(), xk.data_ptr(), dy.data_ptr(),
                            out.data_ptr(), part.data_ptr(), B, m, H, H2, D,
                            parts, stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    cin_dw_cuda.launches += 1
    return out


cin_layer_cuda.launches = 0
cin_dxk_cuda.launches = 0
cin_dx0_cuda.launches = 0
cin_dw_cuda.launches = 0

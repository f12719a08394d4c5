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
each counted apart on its own wrapper, both on the tensor cores in 3xTF32:
  * ``cin_dx_cuda(x0, xk, dy, w, need_x0, need_xk)``: dx0 and dxk in one
    launch of ``cin_dx_wgmma``, reassociated around ``U = dy . W`` (``U``
    stays in the block; each N tile of whole filters is folded into dx0's
    and dxk's sums). It takes m padded to 8 or 40 fields (``DX_FIELD_PADS``)
    and H2 up to ``DX_MAX_H2``, which cover every shape xDeepFM and the case
    table use, and refuses others before anything is built.
  * ``cin_dw_cuda(x0, xk, dy)``: the filters' gradient, a sum over the
    batch (``cin_dw_wgmma``: Z made in registers against dy split into
    stage tiles by a pre-pass, the batch in K parts summed in a fixed
    order).
``dw_plan`` and ``dx_plan`` mirror the C entries' plans (tiles, stages,
parts) for the tests; the wrappers size their scratch from the C entries
``cin_dw_plan`` and ``cin_dx_plan``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "cin"
SOURCES = ("cin/csrc/cin.cu",)
MAX_EMBED_DIM = 128    # D: the wrapper's limit since the first kernel
BM = 128               # rows of an M tile (cin.cu's kBM)
STAGE_K = 16           # values of k per stage (cin.cu's kKS * 8)
N_TILES = (16, 64, 200)   # the wgmma widths (cin.cu's n_tile)
DX_FIELD_PADS = (8, 40)   # the padded fields m the dx kernel takes
DX_MAX_H2 = 224           # its K = H2: dy's staged rows beside the W ring

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
    for name in ("cin_dw_plan", "cin_dx_plan"):
        fn = getattr(lib, name)
        fn.argtypes = [_L] + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    dw = lib.cin_dw_launch
    dw.argtypes = [_P] * 6 + [_L] + [_I] * 4 + [_P]
    dw.restype = ctypes.c_int
    dx = lib.cin_dx_launch
    dx.argtypes = [_P] * 8 + [_L] + [_I] * 6 + [_P]
    dx.restype = ctypes.c_int
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


def _n_tile(H2: int) -> int:
    return 16 if H2 <= 16 else (64 if H2 <= 64 else 200)


def _fill_parts(blocks: int, sms: int, most: int) -> int:
    return max(1, min(sms // blocks if blocks < sms else 1, most))


def dw_plan(B: int, m: int, H: int, H2: int, D: int, sms: int) -> dict:
    """``cin_dw_wgmma``'s launch on a card of ``sms`` SMs, as
    ``cin_dw_plan`` works it out: N tile ``ni`` over ``nt`` tiles, fields
    padded to ``mp``, 16-row groups (filter pairs by blocks of 8 fields) in
    M tiles of 8, ``T`` stages over K = B D, and as many K parts as fill
    the SMs (at most T). A function of the shapes and the card alone, so
    two launches sum in the same order."""
    ni = _n_tile(H2)
    nt = -(-H2 // ni)
    mp = -(-m // 8) * 8
    groups = -(-H // 2) * (mp // 8)
    tiles = -(-groups // 8)
    T = -(-B * D // STAGE_K)
    parts = _fill_parts(tiles * nt, sms, T)
    return {"ni": ni, "nt": nt, "mp": mp, "groups": groups, "tiles": tiles,
            "T": T, "parts": parts,
            "split_floats": nt * T * 2 * STAGE_K * ni,
            "part_floats": parts * H2 * H * m if parts > 1 else 0}


def dx_plan(B: int, m: int, H: int, H2: int, D: int, sms: int) -> dict:
    """``cin_dx_wgmma``'s launch on a card of ``sms`` SMs, as
    ``cin_dx_plan`` works it out: fields padded to ``mp`` (8 or 40), an N
    tile of ``ni // mp`` whole filters (200 at mp 40; at mp 8 the width of
    ``N_TILES`` that pads H * 8 columns least, the wider on a tie) over
    ``ntn`` tiles, ``T`` stages over K = H2, M tiles of ``BM`` rows (b, d),
    and as many N parts as fill the SMs (at most ntn)."""
    mp = dx_check(m, H2)
    ni = 200 if mp == 40 else min(reversed(N_TILES),
                                  key=lambda n: -(-8 * H // n) * n)
    ntn = -(-H // (ni // mp))
    T = -(-H2 // STAGE_K)
    tiles = -(-B * D // BM)
    parts = _fill_parts(tiles, sms, ntn)
    return {"ni": ni, "mp": mp, "ntn": ntn, "T": T, "parts": parts,
            "tiles": tiles, "split_floats": ntn * T * 2 * STAGE_K * ni,
            "part_floats": parts * B * m * D if parts > 1 else 0}


def dx_check(m: int, H2: int) -> int:
    """m padded as the dx kernel pads it; raises where that is not one of
    ``DX_FIELD_PADS``, or where H2 is over ``DX_MAX_H2`` (dy's rows staged
    in shared memory beside the W ring: 224 fit an H100's 227 KB)."""
    mp = -(-m // 8) * 8
    if mp not in DX_FIELD_PADS:
        raise ValueError(f"cin_dx_cuda: takes m padded to "
                         f"{' or '.join(map(str, DX_FIELD_PADS))} fields "
                         f"(m <= 8 or 33 <= m <= 40); got m={m}")
    if H2 > DX_MAX_H2:
        raise ValueError(f"cin_dx_cuda: takes H2 <= {DX_MAX_H2}; got "
                         f"H2={H2}")
    return mp


def _c_plan(who: str, entry: str, shape, n: int) -> list:
    """The C entry ``entry``'s plan of a launch at ``shape`` (B, m, H, H2,
    D) on the current device: its ``n`` numbers."""
    out = (ctypes.c_longlong * n)()
    err = getattr(load_library(), entry)(*shape, out)
    if err != 0:
        raise RuntimeError(f"{who}: {entry} failed with CUDA error {err}")
    return list(out)


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


def cin_layer_cuda(x0: torch.Tensor, xk: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x0 [B, m, D], xk [B, H, D], w [H2, H, m], contiguous float32 on one
    CUDA device -> a new ``[B, H2, D]`` float32 tensor."""
    who = "cin_layer_cuda"
    agree = (x0.dim() == xk.dim() == w.dim() == 3
             and xk.shape[0] == x0.shape[0] and xk.shape[2] == x0.shape[2]
             and tuple(w.shape[1:]) == (xk.shape[1], x0.shape[1]))
    _check(who, ("x0", "xk", "w"), x0, xk, w, agree)
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
    cin_layer_cuda.launches += 1
    return out


def cin_dx_cuda(x0: torch.Tensor, xk: torch.Tensor, dy: torch.Tensor,
                w: torch.Tensor, need_x0: bool = True,
                need_xk: bool = True) -> tuple:
    """(dx0 [B, m, D], dxk [B, H, D]) of a layer on x0 [B, m, D] and xk [B,
    H, D] with filters w [H2, H, m], for dy [B, H2, D], contiguous float32
    on one CUDA device: one launch of ``cin_dx_wgmma`` (and its splits and
    part sums). A gradient not asked for (``need_x0``, ``need_xk``) is
    None. B = 0 gives empty gradients and launches nothing."""
    who = "cin_dx_cuda"
    agree = (x0.dim() == xk.dim() == dy.dim() == w.dim() == 3
             and xk.shape[0] == x0.shape[0] == dy.shape[0]
             and xk.shape[2] == x0.shape[2] == dy.shape[2]
             and tuple(w.shape) == (dy.shape[1], xk.shape[1], x0.shape[1]))
    _check(who, ("x0", "xk", "dy"), x0, xk, dy, agree)
    _check(who, ("x0", "xk", "w"), x0, xk, w, agree)
    B, m, D = x0.shape
    H, H2 = xk.shape[1], dy.shape[1]
    if min(m, H, H2) < 1:
        raise ValueError(f"{who}: needs m, H and H2 >= 1; got m={m}, H={H}, "
                         f"H2={H2}")
    dx_check(m, H2)
    dev = x0.device
    dx0 = torch.empty((B, m, D), dtype=torch.float32, device=dev) \
        if need_x0 else None
    dxk = torch.empty((B, H, D), dtype=torch.float32, device=dev) \
        if need_xk else None
    if B == 0 or not (need_x0 or need_xk):
        return dx0, dxk
    plan = _c_plan(who, "cin_dx_plan", (B, m, H, H2, D), 8)
    ws = torch.empty(plan[6], dtype=torch.float32, device=dev)
    part = torch.empty(plan[7], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load_library().cin_dx_launch(
        x0.data_ptr(), xk.data_ptr(), dy.data_ptr(), w.data_ptr(),
        dx0.data_ptr() if need_x0 else 0, dxk.data_ptr() if need_xk else 0,
        ws.data_ptr(), part.data_ptr(), B, m, H, H2, D, int(need_x0),
        int(need_xk), stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    cin_dx_cuda.launches += 1
    return dx0, dxk


def cin_dw_cuda(x0: torch.Tensor, xk: torch.Tensor,
                dy: torch.Tensor) -> torch.Tensor:
    """dW [H2, H, m] of a layer on x0 [B, m, D] and xk [B, H, D], for dy
    [B, H2, D], contiguous float32 on one CUDA device: ``cin_split_dy`` and
    ``cin_dw_wgmma`` in the K parts of ``cin_dw_plan`` (their scratch
    allocated here), summed in order. B = 0 gives zeros and launches
    nothing."""
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
    plan = _c_plan(who, "cin_dw_plan", (B, m, H, H2, D), 9)
    ds = torch.empty(plan[7], dtype=torch.float32, device=dev)
    part = torch.empty(plan[8], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load_library().cin_dw_launch(
        x0.data_ptr(), xk.data_ptr(), dy.data_ptr(), out.data_ptr(),
        ds.data_ptr(), part.data_ptr(), B, m, H, H2, D, stream)
    if err != 0:
        raise RuntimeError(f"{who}: launch failed with CUDA error {err}")
    cin_dw_cuda.launches += 1
    return out


cin_layer_cuda.launches = 0
cin_dx_cuda.launches = 0
cin_dw_cuda.launches = 0

"""ctypes wrappers of the hand-written CUDA kernels of the edge relax.

  * ``edge_relax_cuda`` (``csrc/edge_relax.cu``) replaces the Pallas kernel
    ``repro/kernels/edge_relax/kernel.py`` (``_relax_kernel``): one
    superstep;
  * ``megakernel_cuda`` (``csrc/megakernel.cu``) replaces
    ``repro/kernels/edge_relax/megakernel.py`` (``_mega_kernel``): up to K
    supersteps in one cooperative launch.

Each library is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``). A wrapper checks device, dtype, shape and
contiguity, allocates its outputs, launches on PyTorch's current stream
without synchronising, raises when the launch is refused (the C entry
returns the CUDA error), and adds one to its own ``.launches`` counter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

NAME = "edge_relax"
SOURCES = ("edge_relax/csrc/edge_relax.cu",)
MEGA_NAME = "megakernel"
MEGA_SOURCES = ("edge_relax/csrc/megakernel.cu",)
STATS_W = 8      # megakernel stats row width (megakernel.py's layout)

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


@functools.lru_cache(maxsize=None)
def load_mega_library() -> ctypes.CDLL:
    """Build (if needed) and load the megakernel library."""
    lib = _build.load(MEGA_NAME, MEGA_SOURCES)
    fn = lib.megakernel_launch
    fn.argtypes = [_P] * 25 + [_I] * 7 + [_P]
    fn.restype = ctypes.c_int
    lib.megakernel_resident_blocks.argtypes = []
    lib.megakernel_resident_blocks.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, length: int, device,
           dtype=torch.int32, who: str = "edge_relax_cuda") -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{who}: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != length:
        raise ValueError(f"{who}: {name} must have shape [{length}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_delta(delta: int, who: str) -> int:
    delta = int(delta)
    if not 1 <= delta <= 2**30:
        raise ValueError(f"{who}: delta must be in [1, 2^30], got {delta}")
    return delta


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
    delta = _check_delta(delta, "edge_relax_cuda")
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


def megakernel_cuda(
    planes: Sequence[torch.Tensor],   # (d, c, p), int32 [n]
    relay: Sequence[torch.Tensor],    # (rw0, rc, rp), int32 [n]
    frozen: torch.Tensor,             # bool [n]
    front: torch.Tensor,              # uint8 [n], 0/1
    row_ptr: torch.Tensor,            # int32 [n+1], dst-sorted CSR
    src: torch.Tensor,                # int32 [E]
    w: torch.Tensor,                  # int32 [E]
    out_ptr: torch.Tensor,            # int32 [n+1], the same edges by src
    out_dst: torch.Tensor,            # int32 [E]
    params: Sequence[int],            # (delta, half_target, num_it,
                                      #  steps_base, stop_variant)
    k_fused: int,
) -> Tuple[torch.Tensor, ...]:
    """Up to ``k_fused`` supersteps in one cooperative launch. Returns
    (d, c, p, front, stats int32 [k_fused + 1, STATS_W])."""
    who = "megakernel_cuda"
    n = row_ptr.shape[0] - 1
    e = src.shape[0]
    dev = row_ptr.device
    _check("row_ptr", row_ptr, n + 1, dev, who=who)
    _check("src", src, e, dev, who=who)
    _check("w", w, e, dev, who=who)
    _check("out_ptr", out_ptr, n + 1, dev, who=who)
    _check("out_dst", out_dst, e, dev, who=who)
    for name, t in zip(("d", "c", "p", "rw0", "rc", "rp"),
                       (*planes, *relay)):
        _check(name, t, n, dev, who=who)
    _check("frozen", frozen, n, dev, dtype=torch.bool, who=who)
    _check("front", front, n, dev, dtype=torch.uint8, who=who)
    k_fused = int(k_fused)
    if k_fused < 1:
        raise ValueError(f"{who}: k_fused must be >= 1, got {k_fused}")
    if n * (k_fused + 1) >= 2**31:
        raise ValueError(f"{who}: n * (k_fused + 1) must fit int32 counts, "
                         f"got n={n}, k_fused={k_fused}")
    delta, half_target, num_it, steps_base, stop_variant = map(int, params)
    delta = _check_delta(delta, who)
    lib = load_mega_library()
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(6)]
    fronts = [torch.empty(n, dtype=torch.uint8, device=dev) for _ in range(2)]
    dirty = torch.zeros((2, n), dtype=torch.uint8, device=dev)
    stats = torch.zeros((k_fused + 1, STATS_W), dtype=torch.int32, device=dev)
    scratch = torch.zeros((k_fused + 1, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (row_ptr, src, w, *planes, front, *relay,
                                   frozen, out_ptr, out_dst, out[0], out[1],
                                   out[2], fronts[0], out[3], out[4], out[5],
                                   fronts[1], dirty[0], dirty[1], stats,
                                   scratch)]
    err = lib.megakernel_launch(*ptrs, delta, half_target, num_it,
                                steps_base, stop_variant, n, k_fused, stream)
    if err != 0:
        raise RuntimeError(
            f"{who}: cooperative launch failed with CUDA error {err} "
            f"(resident capacity {lib.megakernel_resident_blocks()} blocks "
            f"of 256 threads)")
    megakernel_cuda.launches += 1
    return out[0], out[1], out[2], fronts[0], stats


megakernel_cuda.launches = 0

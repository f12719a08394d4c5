"""ctypes wrappers of the hand-written CUDA kernels of the edge relax.

  * ``edge_relax_cuda`` (``csrc/edge_relax.cu``) replaces the Pallas kernel
    ``repro/kernels/edge_relax/kernel.py`` (``_relax_kernel``): one
    superstep;
  * ``megakernel_cuda`` (``csrc/megakernel.cu``) replaces
    ``repro/kernels/edge_relax/megakernel.py`` (``_mega_kernel``): up to K
    supersteps in one cooperative launch.

Both scan a destination row edge-parallel (``csrc/relax_scan.cuh``): G
lanes (4 to 32, from the mean in-degree) per row of at most ``LONG_ROW``
in-edges, a block of 256 threads per longer row, listed by the graph layout
(``ops.RelaxGraph``, which the wrappers take whole, so the list always
matches its CSR), over the node planes packed per node. The megakernel
runs only the rows on its device worklist. Each library is built with
``nvcc`` for ``sm_90a`` at first use (``kernels/_build.py``). A wrapper
checks device, dtype, shape and contiguity, allocates its outputs and
scratch, launches on PyTorch's current stream without synchronising,
raises when the launch is refused (the C entry returns the CUDA error),
and adds one to its own ``.launches`` counter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, Sequence, Tuple

import torch

from repro_torch.kernels import _build

if TYPE_CHECKING:
    from repro_torch.kernels.edge_relax.ops import RelaxGraph

NAME = "edge_relax"
SOURCES = ("edge_relax/csrc/edge_relax.cu",)
MEGA_NAME = "megakernel"
MEGA_SOURCES = ("edge_relax/csrc/megakernel.cu",)
STATS_W = 8      # megakernel stats row width (megakernel.py's layout)
COUNT_W = 8      # megakernel counts row width (one row per stage)
LONG_ROW = 1024  # relax_scan.cuh's kLongRow: a longer row takes a block

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C entry."""
    lib = _build.load(NAME, SOURCES)
    fn = lib.edge_relax_launch
    fn.argtypes = [_P] * 10 + [_I] * 4 + [_P] * 5
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_mega_library() -> ctypes.CDLL:
    """Build (if needed) and load the megakernel library."""
    lib = _build.load(MEGA_NAME, MEGA_SOURCES)
    fn = lib.megakernel_launch
    fn.argtypes = [_P] * 20 + [_I] * 9 + [_P]
    fn.restype = ctypes.c_int
    lib.megakernel_resident_blocks.argtypes = [_I, _I]
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


def _check_graph(g: "RelaxGraph", who: str) -> Tuple[int, int]:
    """The layout's CSR and long-row list: int32, 1-d, contiguous, on one
    CUDA device. Returns (n, E)."""
    n, e = g.n_nodes, g.n_edges
    dev = g.row_ptr.device
    _check("row_ptr", g.row_ptr, n + 1, dev, who=who)
    _check("src", g.src, e, dev, who=who)
    _check("w", g.w, e, dev, who=who)
    if g.long_rows.dim() != 1 or g.long_rows.shape[0] > n:
        raise ValueError(f"{who}: long_rows must be 1-d with at most {n} "
                         f"rows, got {tuple(g.long_rows.shape)}")
    _check("long_rows", g.long_rows, g.long_rows.shape[0], dev, who=who)
    return n, e


def edge_relax_cuda(
    planes: Sequence[torch.Tensor],   # (d, c, p, rw0, rc, rp), int32 [n]
    g: "RelaxGraph",                  # dst-sorted CSR and its long rows
    delta: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One relax superstep on the card. Returns (d_min, c_min, p_min). The
    layout ``g`` (``ops.build_relax_graph``) lists the rows with more than
    ``LONG_ROW`` in-edges, which the kernel scans with a block each."""
    who = "edge_relax_cuda"
    n, e = _check_graph(g, who)
    dev = g.row_ptr.device
    for name, t in zip(("d", "c", "p", "rw0", "rc", "rp"), planes):
        _check(name, t, n, dev, who=who)
    delta = _check_delta(delta, who)
    fn = load_library().edge_relax_launch
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    # the planes packed per node: (d, rw0, c, p) int4, then (rc, rp) int2
    packed = torch.empty(6 * n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(g.row_ptr.data_ptr(), g.src.data_ptr(), g.w.data_ptr(),
             *[t.data_ptr() for t in planes], g.long_rows.data_ptr(),
             int(g.long_rows.shape[0]), delta, n, e,
             *[t.data_ptr() for t in out], packed.data_ptr(), stream)
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
    g: "RelaxGraph",                  # dst-sorted CSR, long rows, out-CSR
    params: Sequence[int],            # (delta, half_target, num_it,
                                      #  steps_base, stop_variant)
    k_fused: int,
) -> Tuple[torch.Tensor, ...]:
    """Up to ``k_fused`` supersteps in one cooperative launch. Returns
    (d, c, p, front, stats int32 [k_fused + 1, STATS_W]). The kernel scans
    ``g``'s long rows with a block each and marks the out-neighbours of
    changed rows through ``g.out_csr()``."""
    who = "megakernel_cuda"
    n, e = _check_graph(g, who)
    dev = g.row_ptr.device
    out_ptr, out_dst = g.out_csr()
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
    n_long = int(g.long_rows.shape[0])
    lib = load_mega_library()
    out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    front_out = torch.empty(n, dtype=torch.uint8, device=dev)
    # the packed state, the slots' records, the worklists and the hub list
    # (no zeroing needed); then the stats, the counts and the two
    # one-bit-per-row bitmaps (zeroed in one fill)
    scratch = torch.empty(13 * n + 4 * n_long, dtype=torch.int32, device=dev)
    rows = (k_fused + 1) * (STATS_W + COUNT_W)
    zeroed = torch.zeros(rows + 2 * ((n + 31) // 32), dtype=torch.int32,
                         device=dev)
    stats = zeroed[:(k_fused + 1) * STATS_W].view(k_fused + 1, STATS_W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (g.row_ptr, g.src, g.w, g.long_rows,
                                   *planes, front, *relay, frozen, out_ptr,
                                   out_dst, *out, front_out, scratch,
                                   zeroed)]
    err = lib.megakernel_launch(*ptrs, delta, half_target, num_it,
                                steps_base, stop_variant, n, e, k_fused,
                                n_long, stream)
    if err != 0:
        raise RuntimeError(
            f"{who}: cooperative launch failed with CUDA error {err} "
            f"(resident capacity {lib.megakernel_resident_blocks(n, e)} "
            f"blocks of 256 threads)")
    megakernel_cuda.launches += 1
    return out[0], out[1], out[2], front_out, stats


megakernel_cuda.launches = 0

"""Device graph layout for the edge-relax kernel and its dispatcher.

``RelaxGraph`` replaces the JAX package's ``block_edges_host``
(``ops.py:53``): instead of dst-sorted [n_blocks, 512] edge blocks padded
per node tile (built by a per-tile host loop), it is a destination-sorted
CSR ordered by (dst, src), built with two stable device sorts and a
bincount — no padding edges, no mask, no Python loop over tiles. The
megakernel also reads the transpose, an out-edge CSR built on first use.

``edge_relax`` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version (``ref.py``) for CPU tensors. There is no fallback: a CUDA
tensor either goes through the kernel or the call raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.edge_relax.kernel import edge_relax_cuda
from repro_torch.kernels.edge_relax.ref import edge_relax_ref


@dataclass
class RelaxGraph:
    """Destination-sorted CSR (edges ordered by (dst, src)) on one device."""

    n_nodes: int
    row_ptr: torch.Tensor   # int32 [n+1]
    src: torch.Tensor       # int32 [E]
    dst: torch.Tensor       # int32 [E] (row of each edge)
    w: torch.Tensor         # int32 [E]
    _out: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, repr=False)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def out_csr(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same edges as an out-edge CSR, ``(out_ptr int32 [n+1],
        out_dst int32 [E])`` ordered by (src, dst); built on first use (the
        megakernel marks the out-neighbours of changed rows through it) and
        kept."""
        if self._out is None:
            order = torch.sort(self.src, stable=True).indices
            src_sorted = self.src[order]
            out_ptr = torch.searchsorted(
                src_sorted, torch.arange(self.n_nodes + 1, dtype=torch.int32,
                                         device=src_sorted.device),
                out_int32=True)
            self._out = (out_ptr, self.dst[order].contiguous())
        return self._out


def build_relax_graph(src: Union[np.ndarray, torch.Tensor],
                      dst: Union[np.ndarray, torch.Tensor],
                      w: Union[np.ndarray, torch.Tensor],
                      n_nodes: int,
                      device: Union[str, torch.device]) -> RelaxGraph:
    """Sort the edges by (dst, src) on ``device`` and build ``row_ptr``."""
    dev = torch.device(device)
    src_t = torch.as_tensor(src, dtype=torch.int32).to(dev)
    dst_t = torch.as_tensor(dst, dtype=torch.int32).to(dev)
    w_t = torch.as_tensor(w, dtype=torch.int32).to(dev)
    if src_t.shape[0] >= 2**31 - 1:
        raise ValueError("edge count must fit int32 row pointers")
    # lexsort((src, dst)): stable sort by the minor key, then the major one
    order = torch.sort(src_t, stable=True).indices
    order = order[torch.sort(dst_t[order], stable=True).indices]
    src_t, dst_t, w_t = src_t[order], dst_t[order], w_t[order]
    # row v starts at the first edge with dst >= v (a bincount would read
    # its output size back to the host)
    row_ptr = torch.searchsorted(
        dst_t, torch.arange(n_nodes + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return RelaxGraph(n_nodes=n_nodes, row_ptr=row_ptr,
                      src=src_t.contiguous(), dst=dst_t.contiguous(),
                      w=w_t.contiguous())


def edge_relax_plain(planes: Sequence[torch.Tensor], g: RelaxGraph,
                     delta) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch superstep over ``g`` on any device (the kernel's
    yardstick on the card, and the CPU path)."""
    idx = g.src.to(torch.int64)
    gathered = [t[idx] for t in planes]
    return edge_relax_ref(*gathered, g.w, g.dst, True, delta, g.n_nodes)


def edge_relax(planes: Sequence[torch.Tensor], g: RelaxGraph,
               delta) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused relax superstep: (d, c, p, rw0, rc, rp) node planes ->
    per-node (d_min, c_min, p_min). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if g.row_ptr.is_cuda:
        return edge_relax_cuda(planes, g.row_ptr, g.src, g.w, int(delta))
    return edge_relax_plain(planes, g, delta)

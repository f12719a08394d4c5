"""Device graph layout for the edge-relax kernel and its dispatcher.

``RelaxGraph`` replaces the JAX package's ``block_edges_host``
(``ops.py:53``): instead of dst-sorted [n_blocks, 512] edge blocks padded
per node tile (built by a per-tile host loop), it is a destination-sorted
CSR ordered by (dst, src), built with two stable device sorts and a
bincount — no padding edges, no mask, no Python loop over tiles. Beside
the CSR it lists the long rows (more than ``LONG_ROW`` in-edges, longest
first), each of which the kernels scan with a whole block: the list is
derived from ``row_ptr`` when the layout is made, so it always matches the
CSR, and costs one read of its length back to the host, once per graph
(the kernels' grid and buffers are sized by it). The megakernel also reads
the transpose, an out-edge CSR built on first use.

With ``inert_tail=True`` (a dynamic session's edge store, a third of whose
slots are inert ``0 -> 0`` self-loops) every self-loop is keyed past the
last row before the sort, so the loops sit after ``row_ptr[n]``, in no
row: no kernel reads them and no host read finds where they start. They
are inert in the relax, so the result is the same as with them in row 0.

``edge_relax`` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version (``ref.py``) for CPU tensors. There is no fallback: a CUDA
tensor either goes through the kernel or the call raises.
"""
from __future__ import annotations

from dataclasses import InitVar, dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import to_device
from repro_torch.kernels.edge_relax.kernel import LONG_ROW, edge_relax_cuda
from repro_torch.kernels.edge_relax.ref import edge_relax_ref


def long_rows_of(row_ptr: torch.Tensor,
                 n_long: Optional[int] = None) -> torch.Tensor:
    """The rows of a CSR with more than ``LONG_ROW`` edges, int32, longest
    first (ties by row id), so their blocks start first: the head of all
    rows sorted by degree (stable, so ties stay in row order). Their count
    ``n_long`` is one counted host read (``guard.fetch``) unless the caller
    knows it."""
    deg = row_ptr[1:] - row_ptr[:-1]
    if n_long is None:
        n_long = int(guard.fetch((deg > LONG_ROW).sum(),
                                 reason="relax graph: long-row count"))
    order = torch.sort(deg, descending=True, stable=True).indices[:n_long]
    return order.to(torch.int32).contiguous()


@dataclass
class RelaxGraph:
    """Destination-sorted CSR (edges ordered by (dst, src)) on one device,
    with its long rows (derived, not passed: ``dataclasses.replace``
    derives them again). With ``inert_tail`` the edges past
    ``row_ptr[n]`` are inert self-loops that belong to no row."""

    n_nodes: int
    row_ptr: torch.Tensor   # int32 [n+1]
    src: torch.Tensor       # int32 [E]
    dst: torch.Tensor       # int32 [E] (row of each edge)
    w: torch.Tensor         # int32 [E]
    inert_tail: bool = field(default=False, kw_only=True)
    # the long rows' count when the builder knows it (else one read); not
    # a field, so dataclasses.replace derives the list again
    n_long: InitVar[Optional[int]] = field(default=None, kw_only=True)
    long_rows: torch.Tensor = field(init=False)  # int32 [L]: > LONG_ROW
    _out: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, init=False, repr=False)

    def __post_init__(self, n_long: Optional[int]) -> None:
        self.long_rows = long_rows_of(self.row_ptr, n_long)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def in_rows(self):
        """Bool [E]: the edges that belong to a row (True without an inert
        tail), for the plain versions that scan the flat arrays."""
        if not self.inert_tail:
            return True
        return (torch.arange(self.n_edges, device=self.src.device)
                < self.row_ptr[-1])

    def out_csr(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same edges as an out-edge CSR, ``(out_ptr int32 [n+1],
        out_dst int32 [E])`` ordered by (src, dst), the inert tail keyed
        past the last row again; built on first use (the megakernel marks
        the out-neighbours of changed rows through it, a row of more than
        ``LONG_ROW`` out-edges with a whole block) and kept."""
        if self._out is None:
            key = (torch.where(self.in_rows(), self.src, self.n_nodes)
                   if self.inert_tail else self.src)
            order = torch.sort(key, stable=True).indices
            out_ptr = torch.searchsorted(
                key[order], torch.arange(self.n_nodes + 1, dtype=torch.int32,
                                         device=key.device),
                out_int32=True)
            self._out = (out_ptr, self.dst[order].contiguous())
        return self._out


def build_relax_graph(src: Union[np.ndarray, torch.Tensor],
                      dst: Union[np.ndarray, torch.Tensor],
                      w: Union[np.ndarray, torch.Tensor],
                      n_nodes: int,
                      device: Union[str, torch.device],
                      inert_tail: bool = False,
                      in_degree: Optional[np.ndarray] = None) -> RelaxGraph:
    """Sort the edges by (dst, src) on ``device``, build ``row_ptr`` and
    list the rows with more than ``LONG_ROW`` in-edges. ``inert_tail``
    sorts every self-loop past the last row. The long rows' count comes
    from the host: from ``in_degree`` (each row's edge count, an edge
    store's) or from numpy edges; device edges without ``in_degree`` read
    it back once (``guard.fetch``)."""
    dev = torch.device(device)
    n_long = None
    if in_degree is not None:
        n_long = int(np.count_nonzero(np.asarray(in_degree) > LONG_ROW))
    elif isinstance(dst, np.ndarray):
        key_h = (np.where(src == dst, n_nodes, dst) if inert_tail
                 else dst).astype(np.int64)
        deg_h = np.bincount(key_h[key_h < n_nodes], minlength=n_nodes)
        n_long = int(np.count_nonzero(deg_h > LONG_ROW))
    src_t, dst_t, w_t = (to_device(a, dev, torch.int32)
                         for a in (src, dst, w))
    if src_t.shape[0] >= 2**31 - 1:
        raise ValueError("edge count must fit int32 row pointers")
    key = (torch.where(src_t == dst_t, n_nodes, dst_t) if inert_tail
           else dst_t)
    # lexsort((src, key)): stable sort by the minor key, then the major one
    order = torch.sort(src_t, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    src_t, dst_t, w_t = src_t[order], dst_t[order], w_t[order]
    # row v starts at the first edge with key >= v (a bincount would read
    # its output size back to the host)
    row_ptr = torch.searchsorted(
        key[order], torch.arange(n_nodes + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return RelaxGraph(n_nodes=n_nodes, row_ptr=row_ptr,
                      src=src_t.contiguous(), dst=dst_t.contiguous(),
                      w=w_t.contiguous(), inert_tail=inert_tail,
                      n_long=n_long)


def edge_relax_plain(planes: Sequence[torch.Tensor], g: RelaxGraph,
                     delta) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch superstep over ``g`` on any device (the kernel's
    yardstick on the card, and the CPU path)."""
    idx = g.src.to(torch.int64)
    gathered = [t[idx] for t in planes]
    return edge_relax_ref(*gathered, g.w, g.dst, g.in_rows(), delta,
                          g.n_nodes)


def edge_relax(planes: Sequence[torch.Tensor], g: RelaxGraph,
               delta) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused relax superstep: (d, c, p, rw0, rc, rp) node planes ->
    per-node (d_min, c_min, p_min). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if g.row_ptr.is_cuda:
        return edge_relax_cuda(planes, g, int(delta))
    return edge_relax_plain(planes, g, delta)

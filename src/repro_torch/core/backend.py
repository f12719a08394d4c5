"""RelaxBackend: one Δ-growing engine, interchangeable executions — the
port of the JAX package's ``core/backend.py`` (single and kernel kinds).

  * ``SingleDeviceBackend`` — flat edge arrays and the plain PyTorch
    superstep (gather + three chained ``scatter_reduce``);
  * ``KernelBackend`` — the counterpart of ``PallasBackend``: a
    destination-sorted CSR and, with ``fuse=0``, one launch of the
    hand-written CUDA relax kernel per superstep; with ``fuse=K > 0``, one
    launch of the cooperative CUDA megakernel per K supersteps (each on its
    plain version for CPU tensors).

Both share the candidate rule and the lexicographic (d, c, pathw)
tuple-min, and ``growth_loop`` owns the stopping rule, so for a fixed seed
they produce byte-identical decompositions.
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import torch

from repro_torch.common import resolve_device
from repro_torch.core.chunked import DEFAULT_CHUNK
from repro_torch.core.delta_growing import (GrowthStats, growth_loop,
                                            partial_growth)
from repro_torch.core.state import EngineState, init_state, relay_planes
from repro_torch.graph.structures import EdgeList
from repro_torch.kernels.edge_relax.kernel import (edge_relax_cuda,
                                                   megakernel_cuda)
from repro_torch.kernels.edge_relax.megakernel import megakernel_growth_loop
from repro_torch.kernels.edge_relax.ops import build_relax_graph, edge_relax

BACKEND_KINDS = ("single", "kernel")


@runtime_checkable
class RelaxBackend(Protocol):
    """What the decomposition engine needs from an execution backend."""

    kind: str          # "single" | "kernel"
    n_nodes: int       # real node count
    n_pad: int         # plane length
    device: torch.device
    transfers: int     # plane packs (one per decomposition)
    launches: int      # hand-written kernel launches made by grow()

    def init_state(self) -> EngineState:
        ...

    def grow(self, state: EngineState, delta: int, half_target: int,
             num_it: int, variant: str,
             chunk: int = DEFAULT_CHUNK) -> Tuple[EngineState, GrowthStats]:
        ...

    def flat_edges(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Flat device ``(src, dst, weight)`` views of the edge buffers the
        backend already holds (the quotient pass and the SSSP loops read
        them)."""
        ...


class SingleDeviceBackend:
    """Flat edge arrays + the plain PyTorch superstep."""

    kind = "single"

    def __init__(self, edges: EdgeList, device="cuda"):
        self.device = resolve_device(device)
        self.n_nodes = edges.n_nodes
        self.n_pad = edges.n_nodes
        self.src = torch.as_tensor(edges.src).to(self.device)
        self.dst = torch.as_tensor(edges.dst).to(self.device)
        self.weight = torch.as_tensor(edges.weight).to(self.device)
        self.transfers = 0
        self.launches = 0   # the plain superstep launches no kernel of ours

    def init_state(self) -> EngineState:
        self.transfers += 1
        return init_state(self.n_pad, self.device)

    def flat_edges(self):
        return self.src, self.dst, self.weight

    def grow(self, state, delta, half_target, num_it, variant,
             chunk=DEFAULT_CHUNK):
        return partial_growth(state, self.src, self.dst, self.weight, delta,
                              half_target, num_it, self.n_pad,
                              variant=variant, chunk=chunk)


class KernelBackend:
    """Destination-sorted CSR + one edge_relax launch per superstep
    (``fuse=0``) or one megakernel launch per ``fuse`` supersteps.

    The reference drops ``fuse`` to 0 with a warning when its planes exceed
    the TPU's VMEM budget. Here the planes live in device memory, so the
    limits are int32 counts (``n * (fuse + 1) < 2^31``, checked here) and
    the cooperative grid's residency: the kernel sizes its grid to what is
    resident, and a device that cannot launch cooperatively makes the
    launch raise. No path drops back to the unfused kernel.
    """

    kind = "kernel"

    def __init__(self, edges: EdgeList, device="cuda", fuse: int = 0):
        fuse = int(fuse)
        if fuse < 0:
            raise ValueError(f"fuse must be >= 0, got {fuse}")
        if fuse and edges.n_nodes * (fuse + 1) >= 2**31:
            raise ValueError(
                f"fuse={fuse} at n={edges.n_nodes}: the megakernel's int32 "
                "counts need n * (fuse + 1) < 2^31")
        self.device = resolve_device(device)
        self.fuse = fuse
        self.n_nodes = edges.n_nodes
        self.n_pad = edges.n_nodes
        self.graph = build_relax_graph(edges.src, edges.dst, edges.weight,
                                       edges.n_nodes, self.device)
        self.transfers = 0
        self.launches = 0

    def init_state(self) -> EngineState:
        self.transfers += 1
        return init_state(self.n_pad, self.device)

    def flat_edges(self):
        return self.graph.src, self.graph.dst, self.graph.w

    def grow(self, state, delta, half_target, num_it, variant,
             chunk=DEFAULT_CHUNK):
        """PartialGrowth where each superstep is one edge_relax call, or,
        with ``fuse > 0``, each launch runs up to ``fuse`` supersteps (the
        kernels on CUDA tensors, their plain versions on CPU tensors)."""
        if self.fuse:
            launches0 = megakernel_cuda.launches
            out = megakernel_growth_loop(state, self.graph, delta,
                                         half_target, num_it, variant,
                                         self.fuse)
            self.launches += megakernel_cuda.launches - launches0
            return out
        rw0, rc, rp, frozen = relay_planes(state)

        def relax_step(s: EngineState):
            return edge_relax((s.d, s.c, s.pathw, rw0, rc, rp), self.graph,
                              delta)

        launches0 = edge_relax_cuda.launches
        out = growth_loop(state, relax_step, frozen, delta, half_target,
                          num_it, variant, chunk)
        self.launches += edge_relax_cuda.launches - launches0
        return out


def make_backend(edges: EdgeList, spec="kernel", *, device="cuda",
                 fuse: int = 0) -> RelaxBackend:
    """Resolve a backend from a kind name (or pass an instance through).
    ``fuse`` applies to the kernel kind only (0 = unfused), as the
    reference's applies to its pallas kind only."""
    if not isinstance(spec, str):
        return spec
    if spec == "single":
        return SingleDeviceBackend(edges, device=device)
    if spec == "kernel":
        return KernelBackend(edges, device=device, fuse=fuse)
    raise ValueError(f"unknown backend {spec!r} (expected one of "
                     f"{BACKEND_KINDS})")

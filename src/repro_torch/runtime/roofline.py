"""The card's rates, one definition for the port and ``chip_smoke.py``.

NVIDIA H100 SXM (Hopper, sm_90), from NVIDIA's data sheet: HBM3 bandwidth
and the dense peak of each arithmetic type. A bound is the larger of the
bytes a function must move over ``HBM_BYTES_PER_S`` and its operations
over the peak of their type.

``relax_pass_bytes`` is the autotuner's price of one Δ-growing superstep
from the graph's size alone (``core/autotune.py``).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12       # dense bf16 on the tensor cores
TF32_FLOPS_PER_S = 495e12       # dense TF32 on the tensor cores
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores


def relax_pass_bytes(n_nodes: int, n_edges: int) -> int:
    """Least bytes one ``edge_relax`` superstep moves when every source is
    admissible: the CSR (``row_ptr`` and each edge's src and w) read once;
    d and rw0 of every node, then c, pathw and rc, rp of every source, read
    once; d, c and pathw written once. ``4(n + 1) + 8e + 36n``. The
    data-dependent count of ``chip_smoke.py``'s ``relax_bytes`` is at most
    this."""
    return 4 * (n_nodes + 1) + 8 * n_edges + 36 * n_nodes

"""The rules a GNN forward of the port is held to, and the faults they
must reject, shared by the CPU tests, the card tests and ``chip_smoke.py``.

**Float32 against float64.** A float32 forward of gatedgcn, meshgraphnet
or equiformer-v2 (layer norms, sigmoids, a softmax, divisions, 12 to 16
layers) has no closed-form error bound as GCN's chain has
(``kernels/segment_mm/cases.py``). Its rules are measured instead, from
the spread of a float32 forward ``plain`` from the float64 forward
``exact`` of the same function on the same inputs; ``rel_max(a, b) =
max|a - b| / max|b|``.
  * Across implementations (the port against the reference, on the CPU):
    every rounding differs, so the rule is global: ``rel_max(o, exact)
    <= SPREAD_C * max(rel_max(plain, exact), SPREAD_FLOOR)``
    (``spread_excess``; pass at <= 1), with the reference's own float32
    forward as ``plain``. Measured on the CPU at smoke and full widths:
    spreads of 1.5e-7 to 2.1e-6, and the port within 0.7 to 2.3 of them.
  * The kernel path against the plain path (on the card): the two share
    every rounding but the sums', so the rule is element by element:
    ``|o - exact| <= SPREAD_C * max(|plain - exact|, ELEM_FLOOR *
    max|exact|)`` everywhere (``elementwise_excess``), with the plain
    path's float32 forward as ``plain``. The global rule cannot see a
    lost message there: equiformer-v2's float32 error is largest at the
    few nodes fed by an edge nearly anti-parallel to z (Rodrigues'
    ``1 / (1 + c)`` rounds the frame badly), the same error on both paths,
    and it hides a dropped edge elsewhere (measured on the card at full
    width on ``molecule``: the global rule read 0.125 for the kernel and
    for the planted fault alike). With the floor, no element is allowed
    less than ``SPREAD_C * ELEM_FLOOR`` = 2^-15 of the largest output,
    about 10 times the largest difference measured on the card between
    the two paths' float32 logits (3.1e-6 of the largest, gatedgcn on
    ``ogb_products``; 3.5e-7 to 1.7e-6 elsewhere).
A dropped edge of a row of mean length (``drop_one_edge``) must read
above the element-wise rule on the card.

**Rotation invariance** (equiformer-v2), two checks.
  * The reference's own (``tests/test_models_deep.py``): the logits under
    ``pos`` rotated about z by ``THETA`` stay within ``INVARIANCE_RULE``
    (1e-3) of the unrotated ones, read as ``max|o1 - o2| / (max|o1| +
    1e-9)`` (``invariance_rel``). A rotation about z leaves each edge's
    cosine to z, and so its frame's rounding, unchanged. It cannot see the
    planted fault (``untransposed_rotation``: messages rotated back with D
    instead of D^T): the frame of an edge rotated about z is the rotated
    frame, so the faulty model is invariant about z too.
  * Under ``ROTATION``, a fixed rotation not about z, on the
    graph without its self-loops (``drop_self_loops``: a self-loop's frame
    is the identity whatever the rotation, and the SO(2) mixes commute
    only with rotations about z, so the reference's model itself is
    invariant only about z where it has self-loops). The exact model is
    invariant there up to the float32 rounding of the Wigner table
    (1.2e-5 in float64 at full width); in float32 each of the two outputs
    is within its spread of float64, and an edge whose vector is nearly
    anti-parallel to z rounds its frame badly (Rodrigues' ``1 / (1 +
    c)``), so the rule is spread-based: ``invariance_rel <= SPREAD_C *
    max(s, s_rot, SPREAD_FLOOR)`` (read as ``invariance_excess``), with
    the two orientations' spreads. The untransposed fault breaks it by
    orders of magnitude.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.kernels.segment_mm.cases import mean_length_row
from repro_torch.kernels.segment_mm.ops import CsrLayout
from repro_torch.models import gnn

SPREAD_C = 8.0
SPREAD_FLOOR = 2.0 ** -22
ELEM_FLOOR = 2.0 ** -18
INVARIANCE_RULE = 1e-3
THETA = 1.1            # the reference's test's angle


def _euler_zyz(a: float, b: float, c: float) -> np.ndarray:
    def rz(t):
        return np.array([[math.cos(t), -math.sin(t), 0.0],
                         [math.sin(t), math.cos(t), 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[math.cos(b), 0.0, math.sin(b)], [0.0, 1.0, 0.0],
                   [-math.sin(b), 0.0, math.cos(b)]])
    return rz(a) @ ry @ rz(c)


ROTATION = _euler_zyz(0.7, 1.1, -0.4)     # float64 [3, 3]


def as64(tree: Any) -> Any:
    """A parameter tree or a graph dict with its floating tensors as
    float64 (the plain path's exact side) and everything else as it is."""
    if isinstance(tree, dict):
        return {k: as64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as64(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.double()
    return tree


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max|a - b| / max|b|`` in float64."""
    a, b = a.double(), b.to(a.device).double()
    return float((a - b).abs().max() / b.abs().max())


def spread_excess(out: torch.Tensor, exact: torch.Tensor,
                  plain: torch.Tensor) -> float:
    """``out``'s distance from the float64 ``exact`` over ``SPREAD_C``
    float32 spreads (``plain``'s distance from it, floored)."""
    spread = max(rel_max(plain, exact), SPREAD_FLOOR)
    return rel_max(out, exact) / (SPREAD_C * spread)


def elementwise_excess(out: torch.Tensor, exact: torch.Tensor,
                       plain: torch.Tensor) -> float:
    """The largest ``|out - exact|`` over ``SPREAD_C`` times ``plain``'s
    own error at that element (floored at ``ELEM_FLOOR`` of the largest
    ``|exact|``)."""
    x = exact.double()
    o, p = out.to(x.device).double(), plain.to(x.device).double()
    allow = SPREAD_C * torch.clamp_min((p - x).abs(),
                                       ELEM_FLOOR * float(x.abs().max()))
    return float(((o - x).abs() / allow).max())


def invariance_rel(out: torch.Tensor, rotated: torch.Tensor) -> float:
    o, r = out.double(), rotated.to(out.device).double()
    return float((o - r).abs().max() / (o.abs().max() + 1e-9))


def invariance_excess(out: torch.Tensor, rotated: torch.Tensor,
                      spread: float) -> float:
    """``invariance_rel`` over ``SPREAD_C`` times ``spread`` (the larger of
    the two orientations' float32 spreads, floored)."""
    return invariance_rel(out, rotated) / (SPREAD_C * max(spread,
                                                          SPREAD_FLOOR))


def rotation_z(theta: float = THETA) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rotated_graph(graph: Dict[str, Any], rot: np.ndarray) -> Dict[str, Any]:
    """``graph`` with ``pos`` rotated by ``rot`` (float64 [3, 3]; the
    product taken in float64, then cast to ``pos``'s dtype), its layouts
    kept: the edges are the same."""
    pos = graph["pos"]
    r = torch.from_numpy(rot).to(pos.device)
    return dict(graph, pos=(pos.double() @ r.T).to(pos.dtype))


def drop_self_loops(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A numpy GNN batch without its self-loops (and their rows of
    ``e``)."""
    keep = batch["src"] != batch["dst"]
    out = dict(batch, src=batch["src"][keep], dst=batch["dst"][keep])
    if "e" in batch:
        out["e"] = batch["e"][keep]
    return out


def drop_first_items(layout: CsrLayout, rows: torch.Tensor) -> CsrLayout:
    """``layout`` without the first item of each row in ``rows`` (each
    non-empty): what a kernel that skips those items would sum."""
    keep = torch.ones_like(layout.col, dtype=torch.bool)
    keep[layout.row_ptr[rows.long()]] = False
    row = layout.row[keep]
    row_ptr = torch.searchsorted(row, torch.arange(
        layout.n_nodes + 1, dtype=torch.int32, device=row.device))
    return CsrLayout(layout.n_nodes, row_ptr, layout.col[keep], row,
                     layout.perm[keep], layout.tile)


def drop_one_edge(graph: Dict[str, Any], cfg) -> Dict[str, Any]:
    """``graph`` as a kernel that loses one message would see it: the first
    in-edge of ``mean_length_row`` dropped from the layout the kind sums
    its messages over (gatedgcn and meshgraphnet: ``edge_layout``;
    equiformer-v2: its K items of ``irrep_layout``)."""
    if cfg.kind not in ("gatedgcn", "meshgraphnet", "equiformer_v2"):
        raise ValueError(f"drop_one_edge: no per-edge layout in a "
                         f"{cfg.kind} forward")
    layout = graph["layout"]
    r = mean_length_row(layout)
    dev = layout.row_ptr.device
    if cfg.kind == "equiformer_v2":
        k = (cfg.l_max + 1) ** 2
        rows = r * k + torch.arange(k, device=dev)
        return dict(graph, irrep_layout=drop_first_items(
            graph["irrep_layout"], rows))
    return dict(graph, edge_layout=drop_first_items(
        graph["edge_layout"], torch.tensor([r], device=dev)))


@contextlib.contextmanager
def untransposed_rotation() -> Iterator[None]:
    """The planted rotation fault: inside, equiformer-v2 rotates its
    messages back to the global frame with D instead of D^T."""
    real = gnn.rotate_irreps

    def faulty(feat, blocks, transpose=False):
        return real(feat, blocks)

    gnn.rotate_irreps = faulty
    try:
        yield
    finally:
        gnn.rotate_irreps = real

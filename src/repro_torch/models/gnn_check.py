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

**Gradients** (a training step's, ``grad_excess``): the same element-wise
rule leaf by leaf, the kernel path's float32 gradient against the plain
path's float64 one, with the spread at each element the largest error of
``GRAD_PLAIN_RUNS`` float32 plain runs that sum in different orders (the
layouts as built, and with their items shuffled: ``shuffled_sums``), all
under ``fixed_order()``, and floored at ``GRAD_ELEM_FLOOR`` (2^-12) of
the leaf's largest magnitude. Measured on the card:
  * The forward's floor (2^-18) is too fine for a gradient. A ReLU whose
    input is within float32 rounding of 0 passes its term on one path and
    not on the other, and the backwards scatter with float atomics
    (``index_add_``, the gradient of every gather) in an order that
    changes from run to run. So an element can move by a whole term:
    4.7e-4 of the leaf's largest magnitude (meshgraphnet at
    ``full_graph_sm``, where the plain path's own error at that element
    was 7e-8); two plain runs read 5.3 against each other there.
  * One plain run is a single draw of the float32 error, and the device's
    scatter order barely varies it. equiformer-v2 at full width on
    ``molecule`` read 0.61 with the pipeline's targets and 1.67 with
    others against one run in fixed order; 0.23 and 0.37 against three
    runs in shuffled orders (other shuffled runs read 0.13-0.22 against
    those three), the planted faults unchanged (2.0 to 50 at the small
    cells). Its float32 gradient is ill-conditioned: nodes whose
    aggregated irreps nearly cancel are divided by their small RMS.
A leaf whose gradient is zero in exact arithmetic (equiformer-v2's last
attention bias: its softmax does not move when every score of a segment
does; its largest ``|exact|`` below ``GRAD_FLOOR`` of the tree's) is
float32 noise of the size of the other leaves' sums, floored at
``GRAD_ELEM_FLOOR`` of the tree's largest magnitude. Where the float64
step does not fit beside the graph (the cut cells), the check runs on a
quarter of the cut, where it does; ``grad_rel`` reads how far two float32
gradients are apart, for the record. A dropped edge of the transposed
layout the backward sums over (``drop_one_transposed``) must read above
the rule where it moves a gradient leaf by more than float32 rounding
does (a few thousand edges); over millions of edges one edge's share of
a parameter's gradient is below it, and the backward launch itself is
held under ``kernels/segment_mm/cases.py``'s rule instead, where the
dropped edge reads far above it.

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
import warnings
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.common import tree_leaves
from repro_torch.kernels.segment_mm.cases import mean_length_row
from repro_torch.kernels.segment_mm.ops import CsrLayout, transpose_layout
from repro_torch.models import gnn

SPREAD_C = 8.0
SPREAD_FLOOR = 2.0 ** -22
ELEM_FLOOR = 2.0 ** -18
GRAD_FLOOR = 2.0 ** -20
GRAD_ELEM_FLOOR = 2.0 ** -12
GRAD_PLAIN_RUNS = 3
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
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
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
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
    floor = ELEM_FLOOR * float(x.abs().max())
    allow = SPREAD_C * torch.clamp_min((p - x).abs(), floor)
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
    return float(((o - x).abs() / allow).max())


@contextlib.contextmanager
def fixed_order() -> Iterator[None]:
    """Inside, PyTorch's deterministic algorithms (``index_add_`` and the
    other scatters in a fixed order; cuBLAS, which warns, is left as it
    is): the gradient check's runs repeat bit for bit."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was)


def grad_excess(got: Any, exact: Any, plains: list,
                per_leaf: bool = False) -> float:
    """The largest ``|got - exact|`` over ``SPREAD_C`` times the largest
    error of the ``plains`` at that element, leaf by leaf, each leaf
    floored at ``GRAD_ELEM_FLOOR`` of its largest ``|exact|`` (of the
    tree's, for a leaf below ``GRAD_FLOOR`` of the tree's, unless
    ``per_leaf``).

    ``per_leaf`` is a model's setting, the same for its sound reading and
    its planted fault's. The GNNs keep the tree floor: some of their
    leaves are zero in exact arithmetic and read at float64 rounding.
    xDeepFM sets it: none of its leaves is zero, and its CIN filters'
    gradients sit some 1e-9 below its DNN's at the reference's init
    scales, under the tree floor."""
    xs = [t.double() for t in tree_leaves(exact)]
    top = max(float(x.abs().max()) for x in xs)
    worst = 0.0
    for o, x, *ps in zip(tree_leaves(got), xs,
                         *[tree_leaves(p) for p in plains]):
        o = o.to(x.device).double()
        scale = float(x.abs().max())
        floor = GRAD_ELEM_FLOOR * (scale if per_leaf
                                   or scale >= GRAD_FLOOR * top else top)
        if floor == 0.0:
            continue
        err = torch.stack([(p.to(x.device).double() - x).abs()
                           for p in ps]).amax(0)
        allow = SPREAD_C * torch.clamp_min(err, floor)
        # sync: a check's verdict, read once per comparison (tests, chip_smoke)
        worst = max(worst, float(((o - x).abs() / allow).max()))
    return worst


def grad_rel(got: Any, plain: Any) -> float:
    """The largest ``max|got - plain|`` of a leaf over the larger of its
    largest ``|plain|`` and ``GRAD_FLOOR`` of the tree's."""
    ps = tree_leaves(plain)
    top = max(float(p.abs().max()) for p in ps)
    worst = 0.0
    for o, p in zip(tree_leaves(got), ps):
        scale = max(float(p.abs().max()), GRAD_FLOOR * top)
        if scale:
            worst = max(worst, float((o.to(p.device) - p).abs().max())
                        / scale)
    return worst


def invariance_rel(out: torch.Tensor, rotated: torch.Tensor) -> float:
    o, r = out.double(), rotated.to(out.device).double()
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
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


def drop_one_transposed(graph: Dict[str, Any], cfg) -> Dict[str, Any]:
    """``graph`` as a backward that loses one edge would see it: the first
    in-edge of ``mean_length_row`` dropped from the transposed layout the
    kind's backward sums its gradient over, and only from it (gcn:
    ``layout_t``, the edge's item in its source's row; gatedgcn and
    meshgraphnet: the edge's row of ``edge_layout_t``; equiformer-v2: its
    K rows of ``irrep_layout_t``)."""
    layout = graph["layout"]
    r = mean_length_row(layout)
    dev = layout.row_ptr.device
    j = layout.row_ptr[r]                       # the edge's sorted position
    if cfg.kind == "gcn":
        lt = graph["layout_t"]
        # the item of sorted position j, in its source's row
        at = torch.nonzero(lt.perm == j).flatten()
        keep = torch.ones_like(lt.col, dtype=torch.bool)
        keep[at] = False
        row = lt.row[keep]
        row_ptr = torch.searchsorted(row, torch.arange(
            lt.n_nodes + 1, dtype=torch.int32, device=dev))
        return dict(graph, layout_t=CsrLayout(lt.n_nodes, row_ptr,
                                              lt.col[keep], row,
                                              lt.perm[keep], lt.tile))
    edge = layout.perm[j]                        # its input position
    if cfg.kind == "equiformer_v2":
        k = (cfg.l_max + 1) ** 2
        rows = edge * k + torch.arange(k, device=dev)
        return dict(graph, irrep_layout_t=drop_first_items(
            graph["irrep_layout_t"], rows))
    if cfg.kind not in ("gatedgcn", "meshgraphnet"):
        raise ValueError(f"drop_one_transposed: unknown kind {cfg.kind}")
    return dict(graph, edge_layout_t=drop_first_items(
        graph["edge_layout_t"], edge.reshape(1)))


def shuffled_sums(graph: Dict[str, Any], cfg, seed: int) -> Dict[str, Any]:
    """``graph`` with the items of every layout a forward of ``cfg`` sums
    over, and so of their transposes, in a random order (from ``seed``):
    the same sums in another float32 order, for the plain path
    (``impl="ref"``, which reads a layout's items in any order)."""
    lays = {"gcn": ("layout",), "gatedgcn": ("edge_layout",),
            "meshgraphnet": ("edge_layout",),
            "equiformer_v2": ("edge_layout", "irrep_layout")}[cfg.kind]
    out = dict(graph)
    gen = torch.Generator().manual_seed(seed)
    for name in lays:
        lay = graph[name]
        p = torch.randperm(lay.col.numel(), generator=gen).to(
            lay.col.device)
        shuffled = CsrLayout(lay.n_nodes, lay.row_ptr, lay.col[p],
                             lay.row[p], lay.perm[p], lay.tile)
        out[name] = shuffled
        out[name + "_t"] = transpose_layout(
            shuffled, graph[name + "_t"].n_nodes, name != "layout")
    return out


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

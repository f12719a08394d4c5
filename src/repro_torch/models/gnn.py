"""GNN inference of the port: the JAX package's ``models/gnn.py`` for its
four kinds (gcn, gatedgcn, meshgraphnet, equiformer-v2; ``init_gnn``,
``gnn_forward``, ``node_classification_loss``, ``graph_regression_loss``)
and its shared pieces (``_mlp_apply``, ``_layernorm``,
``segment_softmax``), with ``models/wigner.py`` for equiformer-v2's
rotations.

The reference sums per-edge tensors with ``jax.ops.segment_sum`` over an
edge index; the port sums every one with ``segment_mm_csr`` over layouts
built once per graph (``resident_graph``), so that on the card every
aggregation is one launch of the hand-written ``segment_mm`` kernel, in a
fixed order (no float atomics):
  * ``layout``: the destination CSR of the edges (``csr_layout``); GCN
    gathers node rows through it with its normalised coefficients.
  * ``edge_layout``: the same CSR with ``col = perm``, so that row n sums
    the per-edge rows of its in-edges (coefficients 1): gatedgcn's ``num``
    and ``den`` (one launch a layer over ``[msg | gate]``, 2 d_hidden
    floats a row), meshgraphnet's ``agg`` (one a block) and equiformer's
    softmax denominator (one a layer).
  * ``irrep_layout``: rows ``n K + k`` summing items ``e K + k`` of an
    ``[E, K, C]`` tensor viewed as ``[E K, C]`` (K = (l_max + 1)^2):
    equiformer's ``agg``, one launch a layer at width C.
So a forward launches ``segment_mm`` n_layers times (gcn, gatedgcn,
meshgraphnet) or twice a layer (equiformer-v2). ``impl="ref"`` maps each
sum to the plain ``segment_mm_ref`` on any device. The dense products stay
``torch.matmul``, as the reference leaves them to XLA; the segment max is
``scatter_reduce("amax")``, the same in any order.

gatedgcn and meshgraphnet run their per-edge work (the edge linears, the
gate, the edge MLP, the layer norm) ``EDGE_CHUNK`` edges at a time, each
chunk's rows written in place, so that a layer holds the edge state and
the aggregation's input and not the reference's per-edge temporaries
(``ogb_products`` has 61,859,140 edges). Every forward computes in the
dtype of its inputs and parameters (float64 too, on the plain path).

Training. Where autograd records a forward (grad enabled and a parameter
requiring grad), nothing is written in place: the per-edge work runs over
every edge at once (a backward keeps each chunk's temporaries anyway) and
each tensor a later step changes is a new one, with the same values as
the in-place forward's. Every sum then differentiates through
``segment_mm_csr``'s backward, one more launch over the transposed layout
(``layout_t``, ``edge_layout_t``, ``irrep_layout_t``), so a training
step launches ``segment_mm`` twice as often as a forward. The transposes
are built once per graph by ``resident_graph(..., train=True)`` (or for
the call where missing). The segment max of the softmax is differentiated
as it is (``scatter_reduce("amax")``'s gradient); in exact arithmetic its
contribution cancels.

A ``graph`` is the reference's dict of tensors (``x`` [N, F], ``src`` /
``dst`` [E], ``labels`` [N]; ``e`` [E, d_edge] for gatedgcn and
meshgraphnet, ``pos`` [N, 3] for equiformer-v2; ``graph_id`` [N] and
``targets`` [G, T] for batched graphs; ``seed_slots`` for a minibatch),
optionally with the prebuilt layouts above and their transposes; a
missing one is built for the call.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_leaves
from repro_torch.config.base import GNNConfig
from repro_torch.kernels.segment_mm.ops import (CsrLayout, csr_layout,
                                                segment_mm_csr,
                                                transpose_layout)
from repro_torch.models.wigner import (edge_rotation, rotate_irreps,
                                       wigner_d_stack)

Params = Dict[str, Any]

KINDS = ("gcn", "gatedgcn", "meshgraphnet", "equiformer_v2")
# the edge-feature widths the reference's GNN cells feed
# (``launch/steps.py``'s ``_GNN_EDGE_DIM``)
GNN_EDGE_DIM = {"gatedgcn": 1, "meshgraphnet": 4}
EDGE_CHUNK = 1 << 20    # edges whose per-edge work runs at a time
N_RBF = 8


def _check_kind(cfg: GNNConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown GNN kind {cfg.kind!r} (expected one of "
                         f"{KINDS})")


# ---------------------------------------------------------------------------
# parameters: shapes per kind, drawn as the reference draws them
# ---------------------------------------------------------------------------

def _lin_shapes(d_in: int, d_out: int) -> Dict[str, Tuple[int, ...]]:
    return {"w": (d_in, d_out), "b": (d_out,)}


def _mlp_shapes(dims: Tuple[int, ...]) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for i in range(len(dims) - 1):
        out[f"w{i}"] = (dims[i], dims[i + 1])
        out[f"b{i}"] = (dims[i + 1],)
    return out


def param_shapes(cfg: GNNConfig, d_in: int, d_edge_in: int = 1) -> Params:
    """The reference's parameter tree for ``cfg``'s kind with a shape tuple
    at each leaf (``gcn_init``, ``gatedgcn_init``, ``meshgraphnet_init``,
    ``equiformer_init``)."""
    _check_kind(cfg)
    d, de = cfg.d_hidden, max(d_edge_in, 1)
    if cfg.kind == "gcn":
        dims = [d_in] + [d] * (cfg.n_layers - 1) + [cfg.d_out]
        return {"layers": [_lin_shapes(dims[i], dims[i + 1])
                           for i in range(len(dims) - 1)]}
    if cfg.kind == "gatedgcn":
        return {"embed_h": _lin_shapes(d_in, d),
                "embed_e": _lin_shapes(de, d),
                "head": _lin_shapes(d, cfg.d_out),
                "layers": [{name: _lin_shapes(d, d) for name in "ABCDE"}
                           for _ in range(cfg.n_layers)]}
    if cfg.kind == "meshgraphnet":
        m = cfg.mlp_layers
        return {"enc_node": _mlp_shapes((d_in,) + (d,) * m),
                "enc_edge": _mlp_shapes((de,) + (d,) * m),
                "dec": _mlp_shapes((d,) * m + (cfg.d_out,)),
                "blocks": [{"edge": _mlp_shapes((3 * d,) + (d,) * m),
                            "node": _mlp_shapes((2 * d,) + (d,) * m)}
                           for _ in range(cfg.n_layers)]}
    C, L, M = cfg.d_hidden, cfg.l_max, cfg.m_max
    layers = []
    for _ in range(cfg.n_layers):
        lp: Params = {"radial": _mlp_shapes((N_RBF, C, (L + 1) * C)),
                      "attn": _mlp_shapes((C, C, cfg.n_heads)),
                      "gate": _lin_shapes(C, (L + 1) * C)}
        for m in range(M + 1):
            fan = (L + 1 - m) * C
            lp[f"so2_r_{m}"] = (fan, fan)
            if m > 0:
                lp[f"so2_i_{m}"] = (fan, fan)
        layers.append(lp)
    return {"embed": _lin_shapes(d_in, C),
            "head": _mlp_shapes((C, C, cfg.d_out)), "layers": layers}


def _init_tree(shapes: Any, gen: torch.Generator) -> Any:
    """Every 2-d leaf ``normal * fan_in^-0.5`` (fan_in its rows: the
    reference's ``_dense`` at every weight), every 1-d leaf zeros (its
    biases), in float32 on ``gen``'s device, drawn in the tree's order."""
    if isinstance(shapes, dict):
        return {k: _init_tree(v, gen) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_init_tree(v, gen) for v in shapes]
    if len(shapes) == 1:
        return torch.zeros(shapes, dtype=torch.float32, device=gen.device)
    return torch.randn(shapes, generator=gen, dtype=torch.float32,
                       device=gen.device) * (shapes[0] ** -0.5)


def init_gnn(cfg: GNNConfig, d_in: int, gen: torch.Generator,
             d_edge_in: int = 1) -> Params:
    """Parameters on ``gen``'s device, drawn from ``gen``."""
    return _init_tree(param_shapes(cfg, d_in, d_edge_in), gen)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _mlp_apply(p: Params, x: torch.Tensor, n: int, act=torch.relu,
               final_act: bool = False) -> torch.Tensor:
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def _layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps)


def edge_layout(layout: CsrLayout) -> CsrLayout:
    """``layout`` gathering per-edge rows: ``col = perm``, so that row n
    sums rows ``perm[j]`` of an ``[E, D]`` tensor over its sorted in-edges
    j (with coefficients 1: ``segment_sum``)."""
    return dataclasses.replace(layout, col=layout.perm.to(torch.int32))


def irrep_layout(layout: CsrLayout, k: int) -> CsrLayout:
    """Row ``n k + c`` sums items ``perm[j] k + c`` of an ``[E, k, C]``
    tensor viewed as ``[E k, C]``, over row n's sorted in-edges j, for
    c < k: one ``segment_mm`` launch at width C for an ``[N, k, C]`` sum."""
    n, n_edges = layout.n_nodes, layout.col.numel()
    if n_edges * k >= 2 ** 31 or n * k >= 2 ** 31:
        raise ValueError(f"irrep_layout: {n_edges} edges or {n} nodes "
                         f"times K = {k} pass 2^31")
    dev = layout.row_ptr.device
    deg = layout.in_degree()
    kk = torch.arange(k, dtype=torch.int64, device=dev)
    starts = (k * layout.row_ptr[:-1, None] + kk[None, :] * deg[:, None])
    row_ptr = torch.cat([starts.reshape(-1),
                         starts.new_full((1,), k * n_edges)])
    row = torch.repeat_interleave(
        torch.arange(n * k, dtype=torch.int64, device=dev),
        deg.repeat_interleave(k), output_size=n_edges * k)
    t = torch.arange(n_edges * k, dtype=torch.int64, device=dev) \
        - row_ptr[row]
    items = layout.perm[layout.row_ptr[row // k] + t] * k + row % k
    return CsrLayout(n * k, row_ptr, items.to(torch.int32),
                     row.to(torch.int32), items, layout.tile)


def segment_sum(x: torch.Tensor, layout: CsrLayout, impl: str = "auto",
                layout_t: Optional[CsrLayout] = None) -> torch.Tensor:
    """``[layout.n_nodes, D]``: row n the sum of ``x``'s rows that
    ``layout`` gathers into it (``edge_layout``, ``irrep_layout``), with
    coefficients 1: ``jax.ops.segment_sum`` of the per-edge rows.
    ``layout_t`` is the transpose a backward sums over."""
    ones = torch.ones(layout.col.numel(), dtype=x.dtype, device=x.device)
    return segment_mm_csr(x, layout, ones, impl=impl, layout_t=layout_t)


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor,
                    num_segments: int, layout: Optional[CsrLayout] = None,
                    impl: str = "auto",
                    layout_t: Optional[CsrLayout] = None) -> torch.Tensor:
    """Softmax of ``scores`` [E, ...] over the entries of each segment:
    the max a ``scatter_reduce("amax")``, the sum ``segment_sum`` over
    ``layout`` (an ``edge_layout`` of edges whose destinations are ``seg``;
    built here, with its transpose, if not given), the denominator floored
    at 1e-9."""
    if layout is None:
        layout = edge_layout(csr_layout(torch.zeros_like(seg), seg,
                                        num_segments))
        if torch.is_grad_enabled() and scores.requires_grad:
            layout_t = transpose_layout(layout, seg.shape[0],
                                        gathers_once=True)
    n_edges = scores.shape[0]
    flat = scores.reshape(n_edges, -1)
    smax = torch.full((num_segments, flat.shape[1]), float("-inf"),
                      dtype=scores.dtype, device=scores.device).scatter_reduce(
        0, seg.long()[:, None].expand_as(flat), flat, "amax")
    ex = torch.exp(flat - _rows(smax, seg))
    den = segment_sum(ex, layout, impl, layout_t)
    return (ex / torch.clamp_min(_rows(den, seg), 1e-9)).reshape(
        scores.shape)


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along dim 0, as ``index_select``: the same values, and
    a gradient summed by ``index_add_``. The gradient of ``x[index]``
    (``index_put_`` with accumulation) adds the rows of one index one
    after another, which at a hub (a minibatch's padding node has
    thousands of self-loops) takes the step's time."""
    return torch.index_select(x, 0, index)


def _edge_slices(n_edges: int) -> List[slice]:
    return [slice(lo, min(lo + EDGE_CHUNK, n_edges))
            for lo in range(0, n_edges, EDGE_CHUNK)]


def _taping(params: Any) -> bool:
    """Whether autograd records a forward of ``params``: grad enabled and
    a parameter requiring grad."""
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in tree_leaves(params))


def _edge_pass(fn, n_edges: int, tape: bool, outs) -> Tuple[torch.Tensor,
                                                            ...]:
    """Per-edge work ``fn(sl) -> tensors``. Under autograd (``tape``) it
    runs once over every edge and its tensors are returned (nothing is
    written in place: a backward needs the values); else ``EDGE_CHUNK``
    edges at a time, each chunk's tensors written into ``outs()``'s, which
    are returned."""
    if tape:
        return fn(slice(None))
    bufs = outs()
    for sl in _edge_slices(n_edges):
        for b, t in zip(bufs, fn(sl)):
            b[sl] = t
    return bufs


def _layouts(graph: Mapping[str, Any], names: Tuple[str, ...],
             transposed: Tuple[str, ...] = (),
             k: int = 0) -> Dict[str, CsrLayout]:
    """The graph's layouts among ``layout``, ``edge_layout`` and
    ``irrep_layout`` (at ``k`` items an edge) that ``names`` lists, and
    the transposes (``<name>_t``) of those ``transposed`` lists, each
    built where missing (an irrep layout of another ``k`` is built again,
    with its transpose)."""
    n, n_edges = graph["x"].shape[0], graph["src"].shape[0]
    layout = graph.get("layout")
    if layout is None:
        layout = csr_layout(graph["src"], graph["dst"], n)
    out = {"layout": layout}
    n_src = {"layout": n, "edge_layout": n_edges,
             "irrep_layout": n_edges * k}
    for name in names:
        lay, lay_t = graph.get(name), graph.get(name + "_t")
        if name == "layout":
            lay = layout
        if name == "edge_layout" and lay is None:
            lay, lay_t = edge_layout(layout), None
        if name == "irrep_layout" and (lay is None or lay.n_nodes != n * k):
            lay, lay_t = irrep_layout(layout, k), None
        out[name] = lay
        if name in transposed:
            out[name + "_t"] = lay_t if lay_t is not None else \
                transpose_layout(lay, n_src[name], name != "layout")
    return out


# the layouts each kind's forward sums over; a backward sums over their
# transposes
_SUMMED = {"gcn": ("layout",), "gatedgcn": ("edge_layout",),
           "meshgraphnet": ("edge_layout",),
           "equiformer_v2": ("edge_layout", "irrep_layout")}


def _summed_layouts(graph: Mapping[str, Any], cfg: GNNConfig, params: Any,
                    k: int = 0) -> Dict[str, CsrLayout]:
    """The layouts a forward of ``cfg`` sums over, with their transposes
    where autograd records it."""
    names = _SUMMED[cfg.kind]
    return _layouts(graph, names, names if _taping(params) else (), k)


def _edge_input(graph: Mapping[str, Any], like: torch.Tensor
                ) -> torch.Tensor:
    e_in = graph.get("e")
    if e_in is None:
        e_in = torch.ones((graph["src"].shape[0], 1), dtype=like.dtype,
                          device=like.device)
    return e_in


# ---------------------------------------------------------------------------
# GCN  (Kipf & Welling; sym-normalized SpMM)
# ---------------------------------------------------------------------------

def gcn_norm(layout: CsrLayout, norm: str
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``deg`` (in-degree + 1 for the self loop, float32), the per-edge
    coefficients in the layout's order, and the self-loop coefficients, as
    the reference forms them: ``rsqrt(deg[src]) * rsqrt(deg[dst])`` and
    ``1 / deg`` for ``norm="sym"``, ``1 / deg[dst]`` otherwise. The
    in-degree is an exact count here, as the reference's float32
    ``segment_sum`` of ones is below 2^24."""
    deg = layout.in_degree().to(torch.float32) + 1.0
    if norm == "sym":
        coeff = torch.rsqrt(deg[layout.col]) * torch.rsqrt(deg[layout.row])
    else:
        coeff = (1.0 / deg)[layout.row]
    return deg, coeff, 1.0 / deg


def gcn_layer(x: torch.Tensor, lp: Params, layout: CsrLayout,
              coeff: torch.Tensor, self_coeff: torch.Tensor, relu: bool,
              impl: str = "auto",
              layout_t: Optional[CsrLayout] = None) -> torch.Tensor:
    """One GCN layer: ``segment_mm(x W) + (x W) / deg + b``, then ReLU on
    all but the last layer (``layout_t``: the transpose a backward sums
    over)."""
    h = x @ lp["w"]
    agg = segment_mm_csr(h, layout, coeff, impl=impl, layout_t=layout_t)
    out = agg + h * self_coeff[:, None] + lp["b"]
    return torch.relu(out) if relu else out


def gcn_forward(params: Params, graph: Mapping[str, Any], cfg: GNNConfig,
                impl: str = "auto") -> torch.Tensor:
    """The graph's prebuilt ``"layout"`` (and under autograd
    ``"layout_t"``) is used if it has one; else one is built for this
    call."""
    lays = _summed_layouts(graph, cfg, params)
    layout = lays["layout"]
    _, coeff, self_coeff = gcn_norm(layout, cfg.norm)
    x = graph["x"]
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        x = gcn_layer(x, lp, layout, coeff, self_coeff,
                      relu=i < n_layers - 1, impl=impl,
                      layout_t=lays.get("layout_t"))
    return x


# ---------------------------------------------------------------------------
# GatedGCN  (Bresson & Laurent; edge-gated residual message passing)
# ---------------------------------------------------------------------------

def gatedgcn_forward(params: Params, graph: Mapping[str, Any],
                     cfg: GNNConfig, impl: str = "auto") -> torch.Tensor:
    """Each layer writes ``[gate * (B h)[src] | gate]`` of every edge into
    one ``[E, 2 d]`` buffer and sums it once: ``num`` and ``den``."""
    src, dst = graph["src"], graph["dst"]
    tape = _taping(params)
    lays = _summed_layouts(graph, cfg, params)
    h = _lin(params["embed_h"], graph["x"])
    e_in = _edge_input(graph, h)
    n_edges, d = src.shape[0], h.shape[1]
    e, = _edge_pass(lambda sl: (_lin(params["embed_e"], e_in[sl]),),
                    n_edges, tape, lambda: (h.new_empty((n_edges, d)),))
    buf = None if tape else h.new_empty((n_edges, 2 * d))  # [msg | gate]
    for lp in params["layers"]:
        dh, eh, bh = _lin(lp["D"], h), _lin(lp["E"], h), _lin(lp["B"], h)

        def edges(sl, e=e):
            s = src[sl]
            e_new = _lin(lp["C"], e[sl]) + _rows(dh, s) + _rows(eh, dst[sl])
            gate = torch.sigmoid(e_new)
            return (gate * _rows(bh, s), gate,
                    e[sl] + torch.relu(_layernorm(e_new)))

        msg, gate, e = _edge_pass(edges, n_edges, tape,
                                  lambda: (buf[:, :d], buf[:, d:], e))
        agg = segment_sum(torch.cat([msg, gate], -1) if tape else buf,
                          lays["edge_layout"], impl,
                          lays.get("edge_layout_t"))
        num, den = agg[:, :d], agg[:, d:]
        h_new = _lin(lp["A"], h) + num / (den + 1e-6)
        h = h + torch.relu(_layernorm(h_new))     # residual + norm
    return _lin(params["head"], h)


# ---------------------------------------------------------------------------
# MeshGraphNet  (Pfaff et al.; encode-process-decode, sum aggregation)
# ---------------------------------------------------------------------------

def meshgraphnet_forward(params: Params, graph: Mapping[str, Any],
                         cfg: GNNConfig, impl: str = "auto") -> torch.Tensor:
    src, dst = graph["src"], graph["dst"]
    tape = _taping(params)
    lays = _summed_layouts(graph, cfg, params)
    m = cfg.mlp_layers
    h = _layernorm(_mlp_apply(params["enc_node"], graph["x"], m))
    e_in = _edge_input(graph, h)
    n_edges = src.shape[0]
    e, = _edge_pass(
        lambda sl: (_layernorm(_mlp_apply(params["enc_edge"], e_in[sl], m)),),
        n_edges, tape, lambda: (h.new_empty((n_edges, h.shape[1])),))
    for blk in params["blocks"]:

        def edges(sl, e=e):
            e_up = _mlp_apply(blk["edge"], torch.cat(
                [_rows(h, src[sl]), _rows(h, dst[sl]), e[sl]], -1), m)
            return (e[sl] + _layernorm(e_up),)

        e, = _edge_pass(edges, n_edges, tape, lambda: (e,))
        agg = segment_sum(e, lays["edge_layout"], impl,
                          lays.get("edge_layout_t"))
        h_up = _mlp_apply(blk["node"], torch.cat([h, agg], -1), m)
        h = h + _layernorm(h_up)
    return _mlp_apply(params["dec"], h, m)


# ---------------------------------------------------------------------------
# EquiformerV2  (eSCN SO(2) convolutions + equivariant attention)
# ---------------------------------------------------------------------------
#
# Irrep features: [N, K, C] with K = (l_max+1)^2 real-SH coefficients.
# Per edge: rotate source features into the edge frame (Wigner-D), mix with
# SO(2) linears per |m| <= m_max (the eSCN trick) scaled by radial-basis
# weights, modulate by scalar attention (softmax over incoming edges from the
# l=0 channel), rotate back, aggregate at the destination, gated nonlinearity
# + equivariant RMS norm per l.

def _sh_index_ranges(l_max: int) -> List[Tuple[int, int]]:
    return [(l * l, (l + 1) * (l + 1)) for l in range(l_max + 1)]


def _m_components(l_max: int, m: int) -> Tuple[List[int], List[int]]:
    """Flat indices of the (+m, -m) coefficient pairs across l >= |m|."""
    pos, neg = [], []
    for l in range(abs(m), l_max + 1):
        base = l * l + l          # m = 0 position of degree l
        pos.append(base + m)
        neg.append(base - m)
    return pos, neg


def _rbf(dist: torch.Tensor, n: int = N_RBF,
         cutoff: float = 5.0) -> torch.Tensor:
    mu = torch.linspace(0.0, cutoff, n, dtype=dist.dtype, device=dist.device)
    beta = (n / cutoff) ** 2
    return torch.exp(-beta * (dist[:, None] - mu[None, :]) ** 2)


@lru_cache(maxsize=None)
def _irrep_indices(l_max: int, m_max: int, device: torch.device
                   ) -> Tuple[torch.Tensor, List[List[torch.Tensor]],
                              torch.Tensor]:
    """On ``device``, once: each coefficient's degree l (``l_of_k``), the
    (+m, -m) index pairs of each |m| <= m_max, and ``at``: coefficient
    k's place in the SO(2) mixes' output (+m then -m for each m, then one
    zero block for those with |m| > m_max)."""
    K = (l_max + 1) ** 2
    l_of_k = torch.tensor([l for l in range(l_max + 1)
                           for _ in range(2 * l + 1)], device=device)
    comps = [[torch.tensor(i, device=device)
              for i in _m_components(l_max, m)] for m in range(m_max + 1)]
    order = [i for m in range(m_max + 1) for i in (
        _m_components(l_max, m)[0]
        + (_m_components(l_max, m)[1] if m else []))]
    at = torch.tensor([order.index(k) if k in order else len(order)
                       for k in range(K)], device=device)
    return l_of_k, comps, at


def equiformer_forward(params: Params, graph: Mapping[str, Any],
                       cfg: GNNConfig, impl: str = "auto") -> torch.Tensor:
    """graph: x [N, F] scalar features, pos [N, 3], src/dst [E]."""
    src, dst, pos = graph["src"], graph["dst"], graph["pos"]
    x = graph["x"]
    n, n_edges = x.shape[0], src.shape[0]
    C, L, M = cfg.d_hidden, cfg.l_max, cfg.m_max
    K = (L + 1) ** 2
    lays = _summed_layouts(graph, cfg, params, K)
    l_of_k, comps, at = _irrep_indices(L, M, x.device)

    vec = pos[dst] - pos[src]
    dist = torch.linalg.vector_norm(vec, dim=-1)
    dmats = wigner_d_stack(edge_rotation(vec), L)
    rbf = _rbf(dist)

    emb = x @ params["embed"]["w"] + params["embed"]["b"]
    feat = torch.cat([emb[:, None, :], emb.new_zeros((n, K - 1, C))], 1)

    for lp in params["layers"]:
        x_rot = rotate_irreps(_rows(feat, src), dmats)      # edge frame
        # radial modulation: per-(l, channel) scale from the distance
        scale = _mlp_apply(lp["radial"], rbf, 2).reshape(-1, L + 1, C)
        x_mod = x_rot * scale[:, l_of_k]
        # SO(2) mixes per |m| <= m_max (coefficients with |m| > m_max drop:
        # the eSCN m-truncation)
        parts = []
        for m, (pos_i, neg_i) in enumerate(comps):
            xp = x_mod[:, pos_i].reshape(n_edges, -1)       # [E, n_l*C]
            wr = lp[f"so2_r_{m}"]
            if m == 0:
                parts.append((xp @ wr).reshape(n_edges, -1, C))
            else:
                xn = x_mod[:, neg_i].reshape(n_edges, -1)
                wi = lp[f"so2_i_{m}"]
                yp = xp @ wr - xn @ wi
                yn = xn @ wr + xp @ wi
                parts += [yp.reshape(n_edges, -1, C),
                          yn.reshape(n_edges, -1, C)]
        parts.append(x_mod.new_zeros((n_edges, 1, C)))
        y = torch.cat(parts, 1)[:, at]
        del parts

        # scalar attention over incoming edges (heads over channel groups)
        scores = _mlp_apply(lp["attn"], y[:, 0, :], 2)      # [E, H]
        alpha = segment_softmax(scores, dst, n, lays["edge_layout"], impl,
                                lays.get("edge_layout_t"))
        alpha_c = alpha.repeat_interleave(C // cfg.n_heads, dim=-1)
        y = y * alpha_c[:, None, :]

        msg = rotate_irreps(y, dmats, transpose=True)       # back to global
        agg = segment_sum(msg.reshape(n_edges * K, C), lays["irrep_layout"],
                          impl, lays.get("irrep_layout_t")).reshape(n, K, C)

        # gated nonlinearity: scalars gate every l-block per channel
        gate = torch.sigmoid(agg[:, 0, :] @ lp["gate"]["w"]
                             + lp["gate"]["b"]).reshape(n, L + 1, C)
        agg = agg * gate[:, l_of_k]

        # equivariant RMS norm per l-block + residual
        normed = []
        for a, b in _sh_index_ranges(L):
            blk = agg[:, a:b]
            rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True)
                             + 1e-6)
            normed.append(blk / rms)
        feat = feat + torch.cat(normed, dim=1)

    # invariant readout from the l=0 channel
    return _mlp_apply(params["head"], feat[:, 0, :], 2)


# ---------------------------------------------------------------------------
# family dispatcher + losses
# ---------------------------------------------------------------------------

_FORWARDS = {"gcn": gcn_forward, "gatedgcn": gatedgcn_forward,
             "meshgraphnet": meshgraphnet_forward,
             "equiformer_v2": equiformer_forward}


def segment_mm_launches(cfg: GNNConfig) -> int:
    """``segment_mm`` launches in one kernel-path forward of ``cfg``: one
    a layer (gcn, gatedgcn, meshgraphnet), two a layer (equiformer-v2: the
    softmax denominator and ``agg``)."""
    _check_kind(cfg)
    return cfg.n_layers * (2 if cfg.kind == "equiformer_v2" else 1)


def gnn_forward(params: Params, graph: Mapping[str, Any], cfg: GNNConfig,
                impl: str = "auto") -> torch.Tensor:
    """``impl`` picks the aggregation (``segment_mm_csr``'s auto | ref)."""
    _check_kind(cfg)
    return _FORWARDS[cfg.kind](params, graph, cfg, impl=impl)


def node_classification_loss(params: Params, graph: Mapping[str, Any],
                             cfg: GNNConfig,
                             impl: str = "auto") -> torch.Tensor:
    """CE over labeled nodes (labels < 0 masked; full-graph + minibatch)."""
    logits = gnn_forward(params, graph, cfg, impl=impl)
    labels = graph["labels"]
    if "seed_slots" in graph:                 # minibatch: loss on seeds only
        logits = logits[graph["seed_slots"]]
        labels = labels[graph["seed_slots"]]
    mask = labels >= 0
    lab = torch.where(mask, labels, 0).to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[:, None])[:, 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1)


def graph_regression_loss(params: Params, graph: Mapping[str, Any],
                          cfg: GNNConfig,
                          impl: str = "auto") -> torch.Tensor:
    """Mean-pool per graph_id + MSE (batched_graphs/molecule regime)."""
    out = gnn_forward(params, graph, cfg, impl=impl)
    gid = graph["graph_id"]
    ng = graph["targets"].shape[0]
    pooled = torch.zeros((ng, out.shape[1]), dtype=out.dtype,
                         device=out.device).index_add_(0, gid, out)
    ones = torch.ones_like(gid, dtype=torch.float32)
    cnt = torch.zeros(ng, dtype=torch.float32,
                      device=out.device).index_add_(0, gid, ones)
    pooled = pooled / cnt[:, None].clamp_min(1)
    return torch.mean((pooled - graph["targets"]) ** 2)


def resident_graph(batch: Mapping[str, Any], device="cuda",
                   cfg: Optional[GNNConfig] = None,
                   train: bool = False) -> Dict[str, Any]:
    """A batch of ``data/pipeline.py``'s GNN batch functions (numpy arrays,
    or tensors) as tensors on ``device`` (int32 ids and labels, float32
    features), with its layouts built there once: ``"layout"`` and
    ``"edge_layout"``, and for an equiformer-v2 ``cfg`` ``"irrep_layout"``
    at its K; with ``train`` also their transposes, which a backward sums
    over (``"layout_t"``, ``"edge_layout_t"``, ``"irrep_layout_t"``). For
    a ``cfg`` of a kind that takes edge features, a batch's ``"e"`` must
    have the width the reference's cells feed it (``GNN_EDGE_DIM``)."""
    dev = resolve_device(device)
    if cfg is not None:
        _check_kind(cfg)
        want = GNN_EDGE_DIM.get(cfg.kind)
        if "e" in batch and want is not None and (
                np.ndim(batch["e"]) != 2 or np.shape(batch["e"])[1] != want):
            raise ValueError(f"resident_graph: {cfg.kind} takes edge "
                             f"features e [E, {want}], got "
                             f"{np.shape(batch['e'])}")
    graph: Dict[str, Any] = {
        k: (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v))).to(dev)
        for k, v in batch.items()}
    k = (cfg.l_max + 1) ** 2 if cfg is not None and \
        cfg.kind == "equiformer_v2" else 0
    names = ("layout", "edge_layout") + (("irrep_layout",) if k else ())
    transposed = ()
    if train:       # what the kind's backward sums over (all, without cfg)
        transposed = names if cfg is None else _SUMMED[cfg.kind]
    graph.update(_layouts(graph, names, transposed, k))
    return graph

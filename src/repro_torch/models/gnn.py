"""GNN inference of the port: the GCN path of the JAX package's
``models/gnn.py`` (``_dense``, ``gcn_init``, ``gcn_forward``,
``init_gnn``, ``gnn_forward``, ``node_classification_loss``,
``graph_regression_loss``).

The reference aggregates with ``jax.ops.segment_sum`` over an edge index;
the port aggregates with ``segment_mm_csr`` over a destination-sorted CSR
built once per graph (``resident_graph`` or ``csr_layout``), so that on
the card each GCN layer is exactly one launch of the hand-written
``segment_mm`` kernel. Both compute the same function. The dense products
``x @ W`` stay ``torch.matmul``, as the reference leaves them to XLA.
gatedgcn, meshgraphnet and equiformer-v2 (with ``models/wigner.py``) wait
for their slices: they raise ``NotImplementedError``.

A ``graph`` is the reference's dict of tensors (``x`` [N, F], ``src`` /
``dst`` [E], ``labels`` [N]; ``graph_id`` [N] and ``targets`` [G, T] for
batched graphs; ``seed_slots`` for a minibatch), optionally with
``"layout"``, the prebuilt ``CsrLayout`` of its edges.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.config.base import GNNConfig
from repro_torch.kernels.segment_mm.ops import (CsrLayout, csr_layout,
                                                segment_mm_csr)

Params = Dict[str, Any]

UNPORTED_KINDS = ("gatedgcn", "meshgraphnet", "equiformer_v2")


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"GNN kind {kind!r} is not ported; the port runs gcn (the others "
        f"wait for their slices)")


def _dense(gen: torch.Generator, fan_in: int, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * (fan_in ** -0.5)


# ---------------------------------------------------------------------------
# GCN  (Kipf & Welling; sym-normalized SpMM)
# ---------------------------------------------------------------------------

def gcn_init(cfg: GNNConfig, d_in: int, gen: torch.Generator) -> Params:
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    return {
        "layers": [
            {"w": _dense(gen, dims[i], dims[i], dims[i + 1]),
             "b": torch.zeros(dims[i + 1], dtype=torch.float32,
                              device=gen.device)}
            for i in range(len(dims) - 1)
        ]
    }


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
              impl: str = "auto") -> torch.Tensor:
    """One GCN layer: ``segment_mm(x W) + (x W) / deg + b``, then ReLU on
    all but the last layer."""
    h = x @ lp["w"]
    agg = segment_mm_csr(h, layout, coeff, impl=impl)
    out = agg + h * self_coeff[:, None] + lp["b"]
    return torch.relu(out) if relu else out


def gcn_forward(params: Params, graph: Mapping[str, Any], cfg: GNNConfig,
                impl: str = "auto") -> torch.Tensor:
    """The graph's prebuilt ``"layout"`` is used if it has one; else one is
    built for this call."""
    layout = graph.get("layout")
    if layout is None:
        layout = csr_layout(graph["src"], graph["dst"], graph["x"].shape[0])
    _, coeff, self_coeff = gcn_norm(layout, cfg.norm)
    x = graph["x"]
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        x = gcn_layer(x, lp, layout, coeff, self_coeff,
                      relu=i < n_layers - 1, impl=impl)
    return x


# ---------------------------------------------------------------------------
# family dispatcher + losses
# ---------------------------------------------------------------------------

def init_gnn(cfg: GNNConfig, d_in: int, gen: torch.Generator,
             d_edge_in: int = 1) -> Params:
    """Parameters on ``gen``'s device, drawn from ``gen``."""
    if cfg.kind == "gcn":
        return gcn_init(cfg, d_in, gen)
    if cfg.kind in UNPORTED_KINDS:
        raise _unported(cfg.kind)
    raise ValueError(cfg.kind)


def gnn_forward(params: Params, graph: Mapping[str, Any], cfg: GNNConfig,
                impl: str = "auto") -> torch.Tensor:
    """``impl`` picks the aggregation (``segment_mm_csr``'s auto | ref)."""
    if cfg.kind == "gcn":
        return gcn_forward(params, graph, cfg, impl=impl)
    if cfg.kind in UNPORTED_KINDS:
        raise _unported(cfg.kind)
    raise ValueError(cfg.kind)


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


def resident_graph(batch: Mapping[str, np.ndarray],
                   device="cuda") -> Dict[str, Any]:
    """A batch of ``data/pipeline.py``'s GNN batch functions as tensors
    on ``device`` (int32 ids and labels, float32 features), with its
    layout built there once (``"layout"``)."""
    dev = resolve_device(device)
    graph: Dict[str, Any] = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in batch.items()}
    graph["layout"] = csr_layout(graph["src"], graph["dst"],
                                 graph["x"].shape[0])
    return graph

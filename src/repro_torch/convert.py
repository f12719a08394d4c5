"""Carry state over from the JAX package.

``from_reference`` turns the JAX package's ``EdgeList`` arrays and
``EngineState`` planes, given as numpy, into the port's ``EdgeList`` and
``EngineState`` on a device, so both packages can start from the same
mid-decomposition state. ``transformer_params_from_reference``,
``recsys_params_from_reference`` and ``gnn_params_from_reference`` turn the
reference's transformer, xDeepFM and GNN (all four kinds) parameter
trees, given as numpy, into the port's parameter dicts, so both packages
can run the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.state import EngineState
from repro_torch.graph.structures import EdgeList
from repro_torch.models.gnn import param_shapes

PLANE_NAMES = tuple(f.name for f in dataclasses.fields(EngineState))
_BOOL_PLANES = ("covered", "is_center")


def from_reference(edges_np: Any, planes_np: Any = None,
                   device="cuda") -> Tuple[EdgeList, Optional[EngineState]]:
    """``edges_np``: the reference ``EdgeList`` (any object with
    ``n_nodes``, ``src``, ``dst``, ``weight``). ``planes_np``: the eight
    ``EngineState`` planes as numpy, by name (a mapping or the reference
    ``EngineState``'s ``_asdict()``), or None. Returns the port's
    ``(EdgeList, EngineState or None)``; planes land on ``device``."""
    edges = EdgeList(int(edges_np.n_nodes), np.asarray(edges_np.src),
                     np.asarray(edges_np.dst), np.asarray(edges_np.weight))
    if planes_np is None:
        return edges, None
    if hasattr(planes_np, "_asdict"):
        planes_np = planes_np._asdict()
    dev = resolve_device(device)
    tensors = {}
    for name in PLANE_NAMES:
        dtype = torch.bool if name in _BOOL_PLANES else torch.int32
        tensors[name] = torch.tensor(np.asarray(planes_np[name]), dtype=dtype,
                                     device=dev)
    return edges, EngineState(**tensors)


def _tensor_from_numpy(a: Any, dev: torch.device) -> torch.Tensor:
    """One array as a tensor on ``dev``, bit for bit. ``torch.from_numpy``
    rejects ``ml_dtypes.bfloat16``, so bf16 moves as its raw 16-bit words
    (viewed as int16, then as ``torch.bfloat16``)."""
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def transformer_params_from_reference(params_np: Dict[str, Any], cfg,
                                      device="cuda") -> Dict[str, Any]:
    """The reference's stacked transformer parameter tree (``embed``,
    ``final_norm``, optional ``unembed``, and ``layers`` of ``[L, ...]``
    arrays, the QKV biases and the MoE tensors included), as numpy, turned
    into the port's dict on ``device`` with the same names, shapes and
    values. ``cfg`` is the port's
    ``TransformerConfig``; each array must already be in its dtype."""
    dev = resolve_device(device)
    want = getattr(torch, cfg.dtype)

    def conv(a):
        t = _tensor_from_numpy(a, dev)
        if t.dtype != want:
            raise ValueError(f"transformer_params_from_reference: a "
                             f"{t.dtype} array in a {cfg.dtype} model")
        return t

    return {k: ({kk: conv(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else conv(v))
            for k, v in params_np.items()}


def recsys_params_from_reference(params_np: Dict[str, Any], cfg,
                                 device="cuda") -> Dict[str, Any]:
    """The reference's xDeepFM parameter tree (``tables``, ``linear``,
    ``cin`` list, ``cin_out``, ``mlp`` list of ``{w, b}``, ``bias``), as
    numpy, turned into the port's dict on ``device`` with the same names,
    shapes and values. ``cfg`` is the port's ``RecsysConfig``; every array
    must be float32 and of the shape ``cfg`` gives it."""
    dev = resolve_device(device)
    F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    dims = [F * D + cfg.n_dense] + list(cfg.mlp_dims) + [1]
    cin_in = [F] + list(cfg.cin_layers[:-1])

    def conv(a, shape, name):
        t = _tensor_from_numpy(a, dev)
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"recsys_params_from_reference: {name} is "
                             f"{t.dtype} {tuple(t.shape)}, expected float32 "
                             f"{tuple(shape)}")
        return t

    if len(params_np["cin"]) != len(cfg.cin_layers) \
            or len(params_np["mlp"]) != len(dims) - 1:
        raise ValueError("recsys_params_from_reference: the tree's cin/mlp "
                         "layer counts do not match the config")
    return {
        "tables": conv(params_np["tables"], (F, V, D), "tables"),
        "linear": conv(params_np["linear"], (F, V), "linear"),
        "cin": [conv(w, (hk, h, F), f"cin[{i}]") for i, (w, hk, h) in
                enumerate(zip(params_np["cin"], cfg.cin_layers, cin_in))],
        "cin_out": conv(params_np["cin_out"], (sum(cfg.cin_layers),),
                        "cin_out"),
        "mlp": [{"w": conv(lp["w"], (dims[i], dims[i + 1]), f"mlp[{i}].w"),
                 "b": conv(lp["b"], (dims[i + 1],), f"mlp[{i}].b")}
                for i, lp in enumerate(params_np["mlp"])],
        "bias": conv(params_np["bias"], (), "bias"),
    }


def _gnn_leaves(tree: Any, shapes: Any, dev: torch.device, name: str,
                dtype: torch.dtype = torch.float32) -> Any:
    """``tree`` (numpy leaves) as tensors on ``dev``, walked beside
    ``shapes`` (``models.gnn.param_shapes``): the same keys and list
    lengths, every leaf ``dtype`` of its shape; a ``ValueError`` names the
    first leaf or node that differs."""
    where = name or "the tree"
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"gnn_params_from_reference: {where} has keys "
                             f"{got}, expected {sorted(shapes)}")
        return {k: _gnn_leaves(tree[k], v, dev,
                               f"{name}.{k}" if name else k, dtype)
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree)
            raise ValueError(f"gnn_params_from_reference: {where} has {got} "
                             f"entries, expected {len(shapes)} (the "
                             f"config's layers)")
        return [_gnn_leaves(t, v, dev, f"{name}[{i}]", dtype)
                for i, (t, v) in enumerate(zip(tree, shapes))]
    t = _tensor_from_numpy(tree, dev)
    if t.dtype != dtype or tuple(t.shape) != tuple(shapes):
        raise ValueError(f"gnn_params_from_reference: {name} is {t.dtype} "
                         f"{tuple(t.shape)}, expected "
                         f"{str(dtype).replace('torch.', '')} "
                         f"{tuple(shapes)}")
    return t


# the leaf whose rows are the input width, and the one whose rows are the
# edge-feature width, per kind
_GNN_IN_LEAVES = {"gcn": (("layers", 0, "w"), None),
                  "gatedgcn": (("embed_h", "w"), ("embed_e", "w")),
                  "meshgraphnet": (("enc_node", "w0"), ("enc_edge", "w0")),
                  "equiformer_v2": (("embed", "w"), None)}


def gnn_params_from_reference(params_np: Dict[str, Any], cfg,
                              device="cuda",
                              dtype: torch.dtype = torch.float32
                              ) -> Dict[str, Any]:
    """The reference's parameter tree for ``cfg``'s kind, as numpy, turned
    into the port's dict on ``device`` with the same names, shapes and
    values: gcn ``layers[i].{w, b}``; gatedgcn ``embed_h``, ``embed_e``,
    ``head`` and ``layers[i].{A..E}``; meshgraphnet ``enc_node``,
    ``enc_edge``, ``dec`` and ``blocks[i].{edge, node}.{w0, b0, w1, b1}``;
    equiformer-v2 ``embed``, ``head`` and ``layers[i].{radial, attn, gate,
    so2_r_m, so2_i_m}``. ``cfg`` is the port's ``GNNConfig``; the input
    (and edge-feature) widths are read from the first layer's rows, and
    every array must be of ``dtype`` (float32; float64 for the float64
    checks, and for gradient trees of that structure) and of the shape
    ``cfg`` gives it."""
    if cfg.kind not in _GNN_IN_LEAVES:
        raise ValueError(f"gnn_params_from_reference: unknown GNN kind "
                         f"{cfg.kind!r}")
    dev = resolve_device(device)

    def rows(path):
        node = params_np
        try:
            for p in path:
                node = node[p]
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"gnn_params_from_reference: the {cfg.kind} "
                             f"tree has no leaf {path}") from None
        if np.ndim(node) != 2:
            raise ValueError(f"gnn_params_from_reference: leaf {path} is "
                             f"{np.ndim(node)}-d, expected 2-d")
        return np.shape(node)[0]

    d_leaf, e_leaf = _GNN_IN_LEAVES[cfg.kind]
    shapes = param_shapes(cfg, rows(d_leaf), rows(e_leaf) if e_leaf else 1)
    return _gnn_leaves(params_np, shapes, dev, "", dtype)

"""Step builders for the ported (arch x shape) cells: the eager counterpart
of the JAX package's ``launch/steps.py`` ``build_cell`` for the LM
family's training and serving kinds (``_lm_cell``),
xDeepFM's training and two serving kinds (``_recsys_cell``), the GNN
family's training cell (``_gnn_cell``) and the paper engine's cell
(``_engine_cell``), on one device, with no mesh and no shardings.

``build_cell(arch, shape_name, smoke=False, device="cuda")`` returns a
``Cell``:
  step_fn     ``serve_prefill(params, batch) -> logits [B, S, V]``
              (``prefill``), ``serve_decode(params, cache, tok) -> (logits
              [B, V], cache)`` (``decode``), ``serve(params, batch,
              cin_impl="auto") -> logits [B]`` (``recsys_serve``) or
              ``retrieval(params, query, cin_impl="auto") -> scores [C]``
              (``retrieval``) or ``train_step(params, opt, graph,
              impl="auto") -> (params, opt, loss, stats)`` (the GNN
              family's ``full_graph``, ``minibatch`` and
              ``batched_graphs``) or ``train_step(params, opt, batch,
              cin_impl="auto") -> (params, opt, loss, stats)``
              (``recsys_train``) or ``train_step(params, opt, batch,
              attn_impl="auto") -> (params, opt, loss, stats)`` (the LM
              family's ``train``)
  arg_shapes  name -> (shape, dtype) of the step's inputs besides params
  cfg         the config the step runs (retrieval: ``n_sparse`` = user +
              item fields; an MoE arch: ``moe_groups`` 1)
  device      where ``Cell.inputs`` puts the inputs
  model_flops the reference's analytic useful FLOPs of one step (LM: 6 N
              a token to train, 2 N to serve, N the active parameters of
              an MoE arch; 0 where the reference has none)

An LM cell's ``serve_decode`` decodes one new token against a cache that
already holds ``S - 1`` (the cache's ``len`` is set to ``S - 1``, a Python
int, as the reference sets it), and its MoE dispatch runs in one group:
the reference sets ``moe_groups`` to its mesh's data shards, one here. The
keyword arguments ``batch`` and ``seq_len`` cut an LM cell's shape to what
one card holds; the cell's ``note`` lists each cut against the
``ShapeSpec``.

An LM arch's ``train_4k`` cell (``LMTrainCell``) is the reference's
training step: ``lm_loss`` (the sequence chunked, each chunk's logits
recomputed in the backward; each layer under ``torch.utils.checkpoint``
with the configs' ``remat="full"``), its gradient by autograd (the flash
attention backward kernel on the card), then ``optim/adamw.apply_updates``
in place with ``train_cfg``. Its inputs are ``tokens`` and ``labels``
``[B, S]`` int32. One card holds no LM arch's training state whole, so a
caller cuts ``batch`` and ``seq_len`` (listed in the note) and the depth
through the config (``get_arch``). An MoE arch trains through the
group-local capacity dispatch's gradient in one dispatch group
(``moe_groups`` 1) on one card, where the reference uses its data shards;
its ``model_flops`` counts the active parameters. The routing is the
model's own: the package has no knob that pins it (``chip_smoke.py``
pins it for its check against the plain attention, and only there). A
step reads nothing from the device, and raises when a parameter gets no
gradient.

The ``paper-graph`` arch's cell (``build_cell("paper-graph", "n16M")``,
keyword arguments ``n_nodes`` = 2^24 and ``avg_degree`` = 5 as the
reference's) is an ``EngineCell``: one Δ-growing superstep at roads-USA
scale through a session backend (see ``_engine_cell``).

Retrieval scores one query against ``n_candidates`` with the full model:
``n_sparse // 3`` user fields broadcast over the candidates, the rest item
fields.

A GNN cell (``GNNCell``) is the reference's training step: the loss of
its regime (``batched_graphs``: ``graph_regression_loss``; otherwise
``node_classification_loss``), its gradient by autograd (each
``segment_mm`` launch of the forward has one in the backward, over the
transposed layout), then ``optim/adamw.apply_updates``. Its
``arg_shapes`` are the reference's padded shapes on one device:
``full_graph`` as the shape gives them, ``minibatch`` from
``(batch_nodes, fanout)`` (``data/pipeline.minibatch_padding``) with
``seed_slots``, ``batched_graphs`` with ``graph_id`` and ``targets
[n_graphs, d_out]``. The keyword arguments ``n_nodes`` and ``n_edges``
(``full_graph``: a subgraph the caller picks, such as the first nodes and
the edges among them) and ``batch_nodes`` (``minibatch``) cut the shape
to what one card holds in training, listed in the note; ``train_cfg`` is
the ``TrainConfig`` (the default's values otherwise).

xDeepFM's training cell (``RecsysTrainCell``, ``recsys_train``) is the
reference's: ``bce_loss``, its gradient by autograd (each CIN layer's
forward launch has its gradient kernels in the backward, ``kernels/cin``),
then ``optim/adamw.apply_updates`` with ``train_cfg`` (the keyword
argument; ``TrainConfig()``'s values otherwise). Its ``arg_shapes`` are
the reference's batch: ``ids`` and ``id_mask [B, F, bag]``, ``dense [B,
n_dense]`` and ``labels [B]``. A step raises when a parameter gets no
gradient, where the GNN step takes zeros: in xDeepFM every parameter
reaches the loss, so a missing gradient is a fault (a kernel autograd
cannot see), never a leaf the loss does not use. ``zero1`` shards the
optimizer state across data replicas and means nothing on one device.

Every other family and kind raises ``NotImplementedError`` naming the
ported kinds and the family and kind asked for; an arch the port does not
register raises the registry's ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.common import next_multiple, resolve_device
from repro_torch.config.base import (GNNConfig, GraphEngineConfig,
                                     MoEConfig, RecsysConfig, ShapeSpec,
                                     TrainConfig, TransformerConfig,
                                     shapes_for_family)
from repro_torch.config.registry import get_arch
from repro_torch.core import state as st
from repro_torch.core.backend import KernelBackend, SingleDeviceBackend
from repro_torch.core.engine import default_uniform_fn
from repro_torch.core.session import tau_for
from repro_torch.data.pipeline import minibatch_padding
from repro_torch.graph.structures import EdgeList
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.optim import adamw

# the shape kinds build_cell ports, by family
PORTED_KINDS = {"lm": ("train", "prefill", "decode"),
                "recsys": ("recsys_train", "recsys_serve", "retrieval"),
                "gnn": ("full_graph", "minibatch", "batched_graphs")}


@dataclass
class Cell:
    arch: str
    shape: str
    step_fn: Callable
    arg_shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    cfg: Union[TransformerConfig, RecsysConfig, GNNConfig,
               GraphEngineConfig]
    device: torch.device
    note: str = ""
    model_flops: float = 0.0

    def inputs(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The step's inputs, by ``arg_shapes``' names and dtypes, from numpy
        arrays (other keys, such as a batch's labels, are left out), on the
        cell's device."""
        return {name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(
                    device=self.device, dtype=dtype)
                for name, (_, dtype) in self.arg_shapes.items()}


@dataclass
class EngineCell(Cell):
    """The paper engine's cell: ``n_nodes`` node planes and ``n_edges``
    edge slots, the real edges first and masked ones after."""

    n_nodes: int = 0
    n_edges: int = 0

    def inputs(self, edges: EdgeList) -> Dict[str, torch.Tensor]:
        """``src``, ``dst``, ``weight`` (int32) and ``edge_mask`` (bool) on
        the cell's device: ``edges`` padded with masked edges to the
        cell's edge count. Raises when the node count differs or the graph
        has more edges than the cell."""
        if edges.n_nodes != self.n_nodes:
            raise ValueError(f"the cell has {self.n_nodes} nodes, the graph "
                             f"{edges.n_nodes}")
        if edges.n_edges > self.n_edges:
            raise ValueError(f"the graph has {edges.n_edges} edges, more "
                             f"than the cell's {self.n_edges}")
        pad = self.n_edges - edges.n_edges
        cols = {"src": edges.src, "dst": edges.dst, "weight": edges.weight}
        out = {name: torch.from_numpy(np.concatenate(
                   [np.asarray(a, np.int32), np.zeros(pad, np.int32)])).to(
                   self.device) for name, a in cols.items()}
        out["edge_mask"] = torch.arange(self.n_edges, device=self.device) \
            < edges.n_edges
        return out

    def backend(self, inputs: Dict[str, torch.Tensor], kind: str = "kernel"):
        """A session backend over the inputs on their device: masked slots
        become inert ``0 -> 0, w = 1`` self-loops (the pooled sessions'
        padding); the kernel backend sorts them past its CSR's last row
        (``KernelBackend.from_device``), the single one keeps the flat
        arrays."""
        m = inputs["edge_mask"]
        src = torch.where(m, inputs["src"], 0).to(torch.int32)
        dst = torch.where(m, inputs["dst"], 0).to(torch.int32)
        w = torch.where(m, inputs["weight"], 1).to(torch.int32)
        if kind == "kernel":
            return KernelBackend.from_device(self.n_nodes, src, dst, w)
        if kind == "single":
            return SingleDeviceBackend.from_device(self.n_nodes, src, dst, w)
        raise ValueError(f"unknown backend {kind!r} (single | kernel)")

    def state(self, backend, seed: int = 0):
        """The planes the superstep starts from, stage 0 of a
        CLUSTER run with seed ``seed`` at ``tau_for(n)``: the centers
        of ``uniform(fold_in(fold_in(PRNGKey(seed), 0), 0), n) < p`` with
        ``p = gamma tau log n / n``, promoted, and everyone else
        unreached."""
        n = self.n_nodes
        tau = tau_for(n, self.cfg.tau_fraction)
        p = min(1.0, self.cfg.gamma * tau * max(math.log(max(n, 2)), 1.0) / n)
        u = default_uniform_fn(seed, backend.device)(0, 0, n)
        s0 = backend.init_state()
        return st.reset_in_stage(st.promote_centers(s0, u < p))


def _engine_cell(cfg: GraphEngineConfig, n_nodes: int = 1 << 24,
                 avg_degree: int = 5, device="cuda") -> EngineCell:
    """One Δ-growing superstep on a roads-USA-scale graph: ``n_nodes`` node
    planes and ``n_nodes * avg_degree`` edge slots rounded up to a multiple
    of 8, the reference's ``_engine_cell`` on one device.

    The reference's sharded superstep takes seven node planes (six int32,
    one bool) and ``(src, dst_local, weight, edge_mask)`` per device. The
    port's step, ``superstep(state, backend, delta=2**20)``, takes the
    eight planes of an ``EngineState`` (d, c, pathw, final_c, final_pathw,
    offset: int32; covered, is_center: bool), from which the backend's
    superstep forms the six int32 planes the relax reads (d, c, pathw and
    the relay planes rw0, rc, rp) and the frozen mask; the edges are the
    cell's ``inputs`` bound by ``EngineCell.backend``. It is one
    ``backend.grow`` call of one superstep (``complete``, ``num_it`` 1,
    chunks of 1): on the kernel backend one launch of the ``edge_relax``
    kernel, on the single backend the plain superstep. Returns
    ``(state, GrowthStats)``.
    """
    dev = resolve_device(device)
    n = int(n_nodes)
    e = next_multiple(n * int(avg_degree), 8)

    def superstep(state, backend, delta: int = 1 << 20):
        # chunk 1: the grow loop runs no gated superstep past the one
        return backend.grow(state, delta, 0, 1, "complete", chunk=1)

    arg_shapes = {"src": ((e,), torch.int32), "dst": ((e,), torch.int32),
                  "weight": ((e,), torch.int32),
                  "edge_mask": ((e,), torch.bool)}
    return EngineCell("paper-graph", f"n{n >> 20}M", superstep, arg_shapes,
                      cfg, dev, note="one Delta-growing superstep (1 MR "
                      "round)", n_nodes=n, n_edges=e)


@dataclass
class GNNCell(Cell):
    """The GNN family's training cell. ``init(seed)`` gives the parameters
    (``init_gnn`` from a generator seeded with ``seed`` on the cell's
    device) and their AdamW state; ``graph(batch)`` checks a batch against
    ``arg_shapes`` and makes it resident with the layouts and transposes a
    step sums over (``resident_graph(..., train=True)``), once per
    graph."""

    train_cfg: TrainConfig = TrainConfig()

    def init(self, seed: int = 0):
        d_feat = self.arg_shapes["x"][0][1]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = gnn_mod.init_gnn(self.cfg, d_feat, gen, d_edge_in=(
            gnn_mod.GNN_EDGE_DIM.get(self.cfg.kind, 1)))
        return params, adamw.init_state(params)

    def graph(self, batch) -> Dict[str, object]:
        """``batch`` (numpy arrays or tensors; other keys refused) as the
        step's resident graph."""
        extra = sorted(set(batch) - set(self.arg_shapes))
        if extra:
            raise ValueError(f"{self.arch} x {self.shape}: the cell takes "
                             f"no inputs {extra}")
        for name, (shape, dtype) in self.arg_shapes.items():
            a = batch.get(name)
            got = None if a is None else (
                tuple(a.shape), str(a.dtype).replace("torch.", ""))
            if got != (shape, str(dtype).replace("torch.", "")):
                raise ValueError(f"{self.arch} x {self.shape}: input {name} "
                                 f"is {got}, the cell declares {shape} "
                                 f"{dtype}")
        return gnn_mod.resident_graph(batch, self.device, self.cfg,
                                      train=True)


def _gnn_cell(cfg: GNNConfig, shape: ShapeSpec, dev: torch.device,
              n_nodes=None, n_edges=None, batch_nodes=None,
              train_cfg: TrainConfig = TrainConfig()) -> GNNCell:
    """The reference's GNN training cell on one device, at the shape's
    padded sizes or at the cuts ``n_nodes`` / ``n_edges``
    (``full_graph``) and ``batch_nodes`` (``minibatch``)."""
    cuts = []
    for name, value in (("n_nodes", n_nodes), ("n_edges", n_edges)):
        if value is not None and value != getattr(shape, name):
            if shape.kind != "full_graph":
                raise TypeError(f"{name} cuts a full_graph shape, not "
                                f"{shape.kind}")
            cuts.append(f"{name} {value} of {getattr(shape, name)}")
            shape = dataclasses.replace(shape, **{name: int(value)})
    if batch_nodes is not None and batch_nodes != shape.batch_nodes:
        if shape.kind != "minibatch":
            raise TypeError(f"batch_nodes cuts a minibatch shape, not "
                            f"{shape.kind}")
        cuts.append(f"batch_nodes {batch_nodes} of {shape.batch_nodes}")
        shape = dataclasses.replace(shape, batch_nodes=int(batch_nodes))
    d_feat = shape.d_feat or 32
    if shape.kind == "batched_graphs":
        pad_n = shape.n_graphs * shape.n_nodes
        pad_e = shape.n_graphs * shape.n_edges
        loss_fn = gnn_mod.graph_regression_loss
    elif shape.kind == "minibatch":
        pad_n, pad_e = minibatch_padding(shape)
        loss_fn = gnn_mod.node_classification_loss
    else:  # full_graph
        pad_n, pad_e = shape.n_nodes, shape.n_edges
        loss_fn = gnn_mod.node_classification_loss
    i32, f32 = torch.int32, torch.float32
    arg_shapes = {"x": ((pad_n, d_feat), f32), "src": ((pad_e,), i32),
                  "dst": ((pad_e,), i32), "labels": ((pad_n,), i32)}
    if cfg.kind == "equiformer_v2":
        arg_shapes["pos"] = ((pad_n, 3), f32)
    if cfg.kind in gnn_mod.GNN_EDGE_DIM:
        arg_shapes["e"] = ((pad_e, gnn_mod.GNN_EDGE_DIM[cfg.kind]), f32)
    if shape.kind == "batched_graphs":
        arg_shapes["graph_id"] = ((pad_n,), i32)
        arg_shapes["targets"] = ((shape.n_graphs, cfg.d_out), f32)
    if shape.kind == "minibatch":
        arg_shapes["seed_slots"] = ((shape.batch_nodes,), i32)

    def train_step(params, opt, graph, impl="auto"):
        params = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        loss = loss_fn(params, graph, cfg, impl=impl)
        loss.backward()
        grads = adamw.tree_map(lambda p: p.grad if p.grad is not None
                               else torch.zeros_like(p), params)
        params, opt, stats = adamw.apply_updates(params, opt, grads,
                                                 train_cfg)
        return params, opt, loss.detach(), stats

    return GNNCell(cfg.name, shape.name, train_step, arg_shapes, cfg, dev,
                   note="; ".join(cuts), train_cfg=train_cfg)


def _leaf_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` of a tree of dicts and lists in ``tree_leaves``'
    order, paths joined by ``/``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


@dataclass
class RecsysTrainCell(Cell):
    """xDeepFM's training cell. ``init(seed)`` gives the parameters
    (``recsys.init_params`` seeded with ``seed`` on the cell's device) and
    their AdamW state; ``inputs(batch)`` puts a ``RecsysPipeline`` batch
    on the device, labels included."""

    train_cfg: TrainConfig = TrainConfig()

    def init(self, seed: int = 0):
        params = recsys_mod.init_params(self.cfg, seed=seed,
                                        device=self.device)
        return params, adamw.init_state(params)


def _recsys_train_cell(cfg: RecsysConfig, shape: ShapeSpec,
                       dev: torch.device,
                       train_cfg: TrainConfig = TrainConfig()
                       ) -> RecsysTrainCell:
    """The reference's ``recsys_train`` cell on one device."""
    B, bag = shape.batch, max(cfg.multi_hot, 1)
    i32, f32 = torch.int32, torch.float32

    def train_step(params, opt, batch, cin_impl="auto"):
        params = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        loss = recsys_mod.bce_loss(params, batch, cfg, cin_impl=cin_impl)
        loss.backward()
        missing = [path for path, p in _leaf_paths(params) if p.grad is None]
        if missing:
            raise RuntimeError(f"{cfg.name} x {shape.name}: no gradient "
                               f"reached {missing}")
        grads = adamw.tree_map(lambda p: p.grad, params)
        params, opt, stats = adamw.apply_updates(params, opt, grads,
                                                 train_cfg)
        return params, opt, loss.detach(), stats

    arg_shapes = {"ids": ((B, cfg.n_sparse, bag), i32),
                  "id_mask": ((B, cfg.n_sparse, bag), f32),
                  "dense": ((B, cfg.n_dense), f32),
                  "labels": ((B,), i32)}
    return RecsysTrainCell(cfg.name, shape.name, train_step, arg_shapes, cfg,
                           dev, train_cfg=train_cfg)


def _lm_model_flops(cfg: TransformerConfig, shape: ShapeSpec,
                    kind: str) -> float:
    """The reference's analytic useful FLOPs of one step: 6 N a token to
    train, 2 N a token to prefill, 2 N a sequence to decode, N the active
    parameters of an MoE arch."""
    n = (cfg.active_param_count() if isinstance(cfg, MoEConfig)
         else cfg.param_count())
    if kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


@dataclass
class LMTrainCell(Cell):
    """An LM arch's training cell. ``init(seed)`` gives the parameters
    (``transformer.init_params`` seeded with ``seed`` on the cell's device)
    and their AdamW state."""

    train_cfg: TrainConfig = TrainConfig()

    def init(self, seed: int = 0):
        params = tf_mod.init_params(self.cfg, seed=seed, device=self.device)
        return params, adamw.init_state(params)


def lm_train_step(cfg: TransformerConfig, train_cfg: TrainConfig,
                  total_steps: int = 0) -> Callable:
    """``train_step(params, opt, batch, attn_impl="auto", grad_transform=
    None) -> (params, opt, loss, stats)``: ``lm_loss``, autograd, then
    AdamW in place. ``grad_transform`` maps the gradient tree before the
    update (the launcher's int8 error feedback). The parameters come back
    without their gradients, so none outlives the step."""
    def train_step(params, opt, batch, attn_impl="auto",
                   grad_transform=None):
        params = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        loss = tf_mod.lm_loss(params, batch, cfg, attn_impl=attn_impl)
        loss.backward()
        missing = [path for path, p in _leaf_paths(params) if p.grad is None]
        if missing:
            raise RuntimeError(f"{cfg.name}: no gradient reached {missing}")
        grads = adamw.tree_map(lambda p: p.grad, params)
        for p in adamw.tree_leaves(params):
            p.grad = None
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, stats = adamw.apply_updates(params, opt, grads,
                                                 train_cfg, total_steps)
        return params, opt, loss.detach(), stats

    return train_step


def _lm_cell(cfg: TransformerConfig, shape: ShapeSpec, dev: torch.device,
             batch=None, seq_len=None,
             train_cfg: TrainConfig = TrainConfig()) -> Cell:
    """An LM cell on one device, at the shape's batch and length or at the
    cuts ``batch`` / ``seq_len`` (listed in the note)."""
    if shape.kind != "train" and train_cfg != TrainConfig():
        raise TypeError(f"train_cfg is an argument of a training cell, not "
                        f"of {shape.kind}")
    if isinstance(cfg, MoEConfig):
        # one data shard: the reference sets moe_groups to its mesh's data
        # shards, so its dispatch runs one group per shard
        cfg = dataclasses.replace(cfg, moe_groups=1)
    cuts = []
    if batch is not None and batch != shape.global_batch:
        cuts.append(f"batch {batch} of {shape.global_batch}")
        shape = dataclasses.replace(shape, global_batch=int(batch))
    if seq_len is not None and seq_len != shape.seq_len:
        cuts.append(f"seq_len {seq_len} of {shape.seq_len}")
        shape = dataclasses.replace(shape, seq_len=int(seq_len))
    B, S = shape.global_batch, shape.seq_len
    note = "; ".join(cuts)
    flops = _lm_model_flops(cfg, shape, shape.kind)

    if shape.kind == "train":
        return LMTrainCell(cfg.name, shape.name,
                           lm_train_step(cfg, train_cfg),
                           {"tokens": ((B, S), torch.int32),
                            "labels": ((B, S), torch.int32)}, cfg, dev,
                           note=note, model_flops=flops,
                           train_cfg=train_cfg)

    if shape.kind == "prefill":
        def serve_prefill(params, batch):
            return tf_mod.prefill_step(params, batch["tokens"], cfg)

        return Cell(cfg.name, shape.name, serve_prefill,
                    {"tokens": ((B, S), torch.int32)}, cfg, dev,
                    note=note, model_flops=flops)

    # decode: one new token against a kv cache of S positions
    def serve_decode(params, cache, tok):
        # steady-state decode: the cache already holds S - 1 tokens
        return tf_mod.decode_step(params, dict(cache, len=S - 1), tok, cfg)

    kv = ((cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim),
          getattr(torch, cfg.dtype))
    return Cell(cfg.name, shape.name, serve_decode,
                {"k": kv, "v": kv, "tok": ((B, 1), torch.int32)}, cfg, dev,
                note="; ".join([f"decode against {S}-token cache"] + cuts),
                model_flops=flops)


def build_cell(arch: str, shape_name: str, smoke: bool = False,
               device="cuda", **kw) -> Cell:
    """The ``(arch, shape)`` cell on ``device``. For the ``paper-graph``
    arch, ``shape_name`` is the cell's name (``n16M`` at the default
    size) or ``""``, and ``kw`` (``n_nodes``, ``avg_degree``) sizes it; for
    an LM arch, ``kw`` (``batch``, ``seq_len``) cuts the shape."""
    cfg = get_arch(arch, smoke=smoke)
    if isinstance(cfg, GraphEngineConfig):
        cell = _engine_cell(cfg, device=device, **kw)
        if shape_name not in ("", cell.shape):
            raise KeyError(f"{arch}'s cell at this size is {cell.shape!r}, "
                           f"not {shape_name!r}")
        return cell
    allowed = {"lm": ("batch", "seq_len", "train_cfg"),
               "gnn": ("n_nodes", "n_edges", "batch_nodes", "train_cfg"),
               "recsys": ("train_cfg",)}.get(cfg.family, ())
    extra = sorted(set(kw) - set(allowed))
    if extra:
        raise TypeError(f"{arch} takes no cell arguments {extra}")
    shape = {s.name: s for s in shapes_for_family(cfg.family)}.get(
        shape_name)
    if shape is None or shape.kind not in PORTED_KINDS.get(cfg.family, ()):
        kind = shape.kind if shape is not None else "unknown"
        raise NotImplementedError(
            f"{arch} x {shape_name} is not ported; the port builds the "
            f"recsys family's {', '.join(PORTED_KINDS['recsys'])} shapes, "
            f"the lm family's {', '.join(PORTED_KINDS['lm'])} shapes "
            f"and the gnn family's {', '.join(PORTED_KINDS['gnn'])} shapes, "
            f"and this is the {cfg.family} family's {kind} kind")
    dev = resolve_device(device)
    if cfg.family == "lm":
        return _lm_cell(cfg, shape, dev, **kw)
    if cfg.family == "gnn":
        return _gnn_cell(cfg, shape, dev, **kw)
    if shape.kind == "recsys_train":
        return _recsys_train_cell(cfg, shape, dev, **kw)
    if kw:
        raise TypeError(f"train_cfg is an argument of a training cell, not "
                        f"of {shape.kind}")
    bag = max(cfg.multi_hot, 1)
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "recsys_serve":
        B = shape.batch

        def serve(params, batch, cin_impl="auto"):
            return recsys_mod.forward(params, batch, cfg, cin_impl=cin_impl)

        arg_shapes = {"ids": ((B, cfg.n_sparse, bag), i32),
                      "id_mask": ((B, cfg.n_sparse, bag), f32),
                      "dense": ((B, cfg.n_dense), f32)}
        return Cell(arch, shape_name, serve, arg_shapes, cfg, dev)

    # retrieval: 1 query x n_candidates
    C = shape.n_candidates
    fu = cfg.n_sparse // 3              # user fields
    fi = cfg.n_sparse - fu              # item fields per candidate
    rcfg = dataclasses.replace(cfg, n_sparse=fu + fi)

    def retrieval(params, q, cin_impl="auto"):
        return recsys_mod.retrieval_scores(
            params, q["user_ids"], q["user_mask"], q["user_dense"],
            q["cand_ids"], q["cand_mask"], rcfg, cin_impl=cin_impl)

    arg_shapes = {"user_ids": ((1, fu, bag), i32),
                  "user_mask": ((1, fu, bag), f32),
                  "user_dense": ((1, cfg.n_dense), f32),
                  "cand_ids": ((C, fi, bag), i32),
                  "cand_mask": ((C, fi, bag), f32)}
    return Cell(arch, shape_name, retrieval, arg_shapes, rcfg, dev,
                note=f"1 query x {C} candidates")

"""Step builders for the ported (arch x shape) cells: the eager counterpart
of the JAX package's ``launch/steps.py`` ``build_cell`` for xDeepFM's two
serving kinds (``_recsys_cell``), on one device, with no mesh and no
shardings.

``build_cell(arch, shape_name, smoke=False, device="cuda")`` returns a
``Cell``:
  step_fn     ``serve(params, batch, cin_impl="auto") -> logits [B]``
              (``recsys_serve``) or ``retrieval(params, query,
              cin_impl="auto") -> scores [C]`` (``retrieval``)
  arg_shapes  name -> (shape, dtype) of the step's inputs besides params
  cfg         the config the step runs (retrieval: ``n_sparse`` = user +
              item fields)
  device      where ``Cell.inputs`` puts the inputs

Retrieval scores one query against ``n_candidates`` with the full model:
``n_sparse // 3`` user fields broadcast over the candidates, the rest item
fields. Every other family and kind (``recsys_train`` too) raises
``NotImplementedError`` naming the ported kinds and the family and kind
asked for; an arch the port does not register raises the registry's
``KeyError``. The GNN family has no cell here: the reference's GNN cell is
a training step, which waits for the training slice (GNN inference runs
through ``models/gnn.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.config.base import GNN_SHAPES, RECSYS_SHAPES, RecsysConfig
from repro_torch.config.registry import get_arch
from repro_torch.models import recsys as recsys_mod

# the recsys shape kinds build_cell ports
PORTED_KINDS = ("recsys_serve", "retrieval")


@dataclass
class Cell:
    arch: str
    shape: str
    step_fn: Callable
    arg_shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    cfg: RecsysConfig
    device: torch.device
    note: str = ""

    def inputs(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The step's inputs, by ``arg_shapes``' names and dtypes, from numpy
        arrays (other keys, such as a batch's labels, are left out), on the
        cell's device."""
        return {name: torch.from_numpy(np.ascontiguousarray(arrays[name])).to(
                    device=self.device, dtype=dtype)
                for name, (_, dtype) in self.arg_shapes.items()}


def build_cell(arch: str, shape_name: str, smoke: bool = False,
               device="cuda") -> Cell:
    cfg = get_arch(arch, smoke=smoke)
    shape = {s.name: s for s in RECSYS_SHAPES + GNN_SHAPES}.get(shape_name)
    if cfg.family != "recsys" or shape is None \
            or shape.kind not in PORTED_KINDS:
        kind = shape.kind if shape is not None else "unknown"
        why = (": the reference's GNN cell is a training step, which waits "
               "for the training slice; GNN inference runs through "
               "models/gnn.py" if cfg.family == "gnn" else "")
        raise NotImplementedError(
            f"{arch} x {shape_name} is not ported; the port builds the "
            f"recsys family's {' and '.join(PORTED_KINDS)} shapes, and this "
            f"is the {cfg.family} family's {kind} kind{why}")
    dev = resolve_device(device)
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

"""xDeepFM (arXiv:1803.05170): the port of the JAX package's
``models/recsys.py`` (``embedding_bag``, ``init_params``, ``forward``,
``bce_loss``, ``retrieval_scores``).

The reference vmaps a one-table embedding bag over the fields; here all
fields are one gather over the ``[F, V, D]`` table viewed as ``[F * V, D]``
(``index_select`` at ``f * V + id``), and the reference's ``segment_sum``
over ``repeat(arange(B), bag)`` is a sum over the bag axis.

Branches: linear (per-id weight) + CIN (``kernels/cin``: the hand-written
CUDA kernel on the card, the plain version on the CPU) + DNN. Parameters
are a plain dict with the reference's names and shapes. Both gathers (the
embedding rows and the linear weights) are ``index_select``: its gradient
is a scatter-add that sums repeated ids in parallel, where advanced
indexing's (``index_put_``) adds one index's rows serially.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common import resolve_device
from repro_torch.config.base import RecsysConfig
from repro_torch.kernels.cin.ops import cin

Params = Dict[str, Any]

_INIT_SLICE = 1 << 26   # values drawn per call when initialising a table


def _flat_index(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Row of ``[F * V, ...]`` for each id of ``ids [B, F, bag]``: field f's
    id i is row ``f * V + i``."""
    F = ids.shape[1]
    base = torch.arange(F, dtype=torch.int64, device=ids.device) * vocab
    return ids.to(torch.int64) + base[None, :, None]


def embedding_bag(
    tables: torch.Tensor,      # [F, V, D] one table per field
    ids: torch.Tensor,         # int32 [B, F, bag]
    mask: torch.Tensor,        # [B, F, bag] 1 = valid id
    combiner: str = "mean",
) -> torch.Tensor:
    """Embedding bags of every field at once -> ``[B, F, D]``: the gathered
    rows times the mask, summed over the bag, divided by ``max(count, 1)``
    under ``"mean"`` (the reference's per-field ``embedding_bag``, vmapped
    over the field axis)."""
    F, V, D = tables.shape
    B, _, bag = ids.shape
    rows = tables.reshape(F * V, D).index_select(
        0, _flat_index(ids, V).reshape(-1)).view(B, F, bag, D)
    out = (rows * mask[..., None]).sum(dim=2)
    if combiner == "mean":
        cnt = mask.sum(dim=2)
        out = out / torch.clamp_min(cnt[..., None], 1.0)
    return out


def init_params(cfg: RecsysConfig, seed: int = 0, device="cuda") -> Params:
    """The reference's parameter tree on ``device``, float32: tables and the
    linear weights ``normal * 0.01``, CIN filters ``normal * (H m)^-0.5``,
    ``cin_out`` ``normal * 0.01``, MLP weights ``normal * fan_in^-0.5``,
    biases zero. Drawn from one ``torch.Generator`` seeded with ``seed``,
    large tensors in slices of at most ``_INIT_SLICE`` values."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def normal(scale, *shape):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), _INIT_SLICE):
            part = flat[i:i + _INIT_SLICE]
            part.copy_(torch.randn(part.shape, generator=gen,
                                   dtype=torch.float32, device=dev))
        return out.mul_(scale)

    F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    p: Params = {
        "tables": normal(0.01, F, V, D),
        "linear": normal(0.01, F, V),
        "cin": [],
        "mlp": [],
        "bias": torch.zeros((), dtype=torch.float32, device=dev),
    }
    prev = F
    for hk in cfg.cin_layers:
        p["cin"].append(normal((prev * F) ** -0.5, hk, prev, F))
        prev = hk
    p["cin_out"] = normal(0.01, sum(cfg.cin_layers))
    dims = [F * D + cfg.n_dense] + list(cfg.mlp_dims) + [1]
    for i in range(len(dims) - 1):
        p["mlp"].append({
            "w": normal(dims[i] ** -0.5, dims[i], dims[i + 1]),
            "b": torch.zeros(dims[i + 1], dtype=torch.float32, device=dev),
        })
    return p


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: RecsysConfig,
    cin_impl: str = "auto",
) -> torch.Tensor:
    """batch: ids [B, F, bag] int32, id_mask [B, F, bag], dense [B, n_dense].
    Returns logits [B]. ``cin_impl``: auto (the kernel on CUDA tensors) |
    ref (the plain CIN on any device)."""
    ids, mask = batch["ids"], batch["id_mask"]
    B, F, _ = ids.shape
    D = cfg.embed_dim
    emb = embedding_bag(params["tables"], ids, mask)          # [B, F, D]

    # --- linear branch ------------------------------------------------------
    flat = _flat_index(ids, cfg.vocab_per_field)
    lin_w = (params["linear"].reshape(-1).index_select(0, flat.reshape(-1))
             .view(flat.shape) * mask).sum(dim=-1)             # [B, F]
    logit_lin = lin_w.sum(dim=-1)

    # --- CIN branch -----------------------------------------------------------
    logit_cin = cin(emb, params["cin"], impl=cin_impl) @ params["cin_out"]

    # --- DNN branch -----------------------------------------------------------
    h = torch.cat([emb.reshape(B, F * D), batch["dense"]], dim=-1)
    for i, lp in enumerate(params["mlp"]):
        h = h @ lp["w"] + lp["b"]
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    logit_dnn = h[:, 0]

    return logit_lin + logit_cin + logit_dnn + params["bias"]


def bce_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: RecsysConfig, cin_impl: str = "auto") -> torch.Tensor:
    """The mean binary cross-entropy of ``forward``'s logits against
    ``batch["labels"]`` (cast to float32), in the reference's stable form
    ``max(l, 0) - l y + log1p(exp(-|l|))``."""
    logits = forward(params, batch, cfg, cin_impl=cin_impl)
    y = batch["labels"].to(torch.float32)
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def retrieval_batch(user_ids: torch.Tensor, user_mask: torch.Tensor,
                    user_dense: torch.Tensor, cand_ids: torch.Tensor,
                    cand_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One query's user fields (``[1, F_user, bag]``, dense ``[1, n_dense]``)
    broadcast over ``C`` candidates and joined with their item fields
    (``[C, F_item, bag]``): the ``forward`` batch of ``retrieval_scores``."""
    C = cand_ids.shape[0]
    fu = user_ids.shape[1]
    ids = torch.cat([user_ids.expand(C, fu, user_ids.shape[2]), cand_ids],
                    dim=1)
    mask = torch.cat([user_mask.expand(C, fu, user_mask.shape[2]), cand_mask],
                     dim=1)
    dense = user_dense.expand(C, user_dense.shape[1])
    return {"ids": ids, "id_mask": mask, "dense": dense}


def retrieval_scores(
    params: Params,
    user_ids: torch.Tensor,       # [1, F_user, bag]
    user_mask: torch.Tensor,
    user_dense: torch.Tensor,     # [1, n_dense]
    cand_ids: torch.Tensor,       # [C, F_item, bag]
    cand_mask: torch.Tensor,
    cfg: RecsysConfig,
    cin_impl: str = "auto",
) -> torch.Tensor:
    """Score one query against C candidates with the FULL interaction model
    (batched over broadcast user features, not a per-candidate loop)."""
    return forward(params, retrieval_batch(user_ids, user_mask, user_dense,
                                           cand_ids, cand_mask),
                   cfg, cin_impl=cin_impl)

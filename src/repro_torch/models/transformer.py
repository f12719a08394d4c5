"""Decoder-only transformer: the port of the JAX package's
``models/transformer.py`` for serving and training its five LM archs
(gemma2-9b, mistral-nemo-12b, qwen1.5-32b, and the MoE archs
moonshot-v1-16b-a3b and mixtral-8x7b).

Parameters are a plain dict with layers STACKED on a leading ``[L]`` axis,
as in the reference (``embed``, ``final_norm``, optional ``unembed``, and
``layers`` with ``attn_norm``, ``mlp_norm``, ``wq``, ``wk``, ``wv``, ``wo``,
optional ``bq``/``bk``/``bv``, and ``w_gate``, ``w_up``, ``w_down``; an
MoE config's layers have ``router`` ``[L, d, E]``, ``w_gate``/``w_up``
``[L, E, d, f]``, ``w_down`` ``[L, E, f, d]`` and, with shared experts,
``ws_gate``/``ws_up`` ``[L, d, fs]`` and ``ws_down`` ``[L, fs, d]``).
Attention tensors are ``[B, H, S, D]`` and the KV cache is
``[L, B, Hkv, S, D]``.

The MoE FFN (``_moe_mlp``) is the reference's group-local capacity
dispatch: a float32 router softmax over a model-dtype product, top-k with
ties to the lower expert index (``lax.top_k``'s order), gates renormalised,
the Switch aux loss, ``capacity = ceil(Tg k / E cf)`` (``Tg`` when a group
has fewer tokens than experts, then at least 4), each (token, choice)
pair's position in its expert by a stable sort and ``searchsorted``, pairs
past the capacity dropped with their gates zeroed, dense per-expert
products over the capacity slots, the gate multiply promoted to float32
as JAX promotes bf16 x float32, the combine summed per token, shared
experts added. No step reads the device: shapes and the capacity are
static, and nothing calls ``.item()``, ``nonzero``, boolean-mask indexing
or ``bincount``. Every pair is copied into a flat ``[E * G * C + 1, d]``
buffer by ``index_copy_``: each kept pair owns its (expert, group, slot)
row and the dropped pairs all land on the last row, which no product
reads, so no write needs an atomic add (the reference adds the dropped
pairs, zeroed, into slot ``C - 1``: the same kept values). A decode step
runs every expert's product on its capacity slots, as the reference's, so
it reads every expert's weights.

Where it differs from the reference, on purpose:
  * the layers run as a Python loop with each layer's window static (the
    reference's unrolled branch, ``transformer.py:428-440``), since eager
    PyTorch has no ``lax.scan``; the MoE aux loss is the layers' mean, as
    there;
  * attention goes through ``kernels/flash_attention/ops.attention``: the
    hand-written CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (``attn_impl="ref"`` forces the plain version anywhere);
  * ``decode_step`` writes the new K/V row into the cache in place and
    returns the same tensors; the cache length ``"len"`` is a Python int
    (the serving loop knows it), so no step reads the device;
  * ``init_params`` draws from a seeded ``torch.Generator`` on the device,
    one slice at a time: the values differ from the reference's
    ``jax.random`` init (tests carry the reference's weights over with
    ``convert.transformer_params_from_reference``). It keeps one quirk of
    the reference's: ``ws_gate`` and ``ws_up`` come from one key there,
    so they are equal, and here ``ws_up`` is a copy of ``ws_gate``.
Training: ``lm_loss`` is the reference's next-token cross-entropy,
chunked over the sequence (each chunk's float32 logits recomputed in the
backward by ``torch.utils.checkpoint``, labels ``-1`` masked, an MoE
config's router aux loss added), and a config's ``remat="full"`` wraps
each layer in ``torch.utils.checkpoint`` (non-reentrant) when autograd
records: the layer's forward runs again in the backward, so a layer
launches the flash attention forward twice a step and its backward once.
Under autograd the final softcap is taken out of place (its ``tanh``'s
backward needs its output); the no-grad serve path keeps it in place.
The stacked layer weights are sliced by one ``unbind`` a forward, whose
backward stacks the layers' gradients once (a per-layer index would
write a full-size gradient per layer). Work that the reference does in
float32 is done in ``promote_types(dtype, float32)``: float32 for the bf16
and float32 configs, float64 for a float64 one (the tests' precision).
An MoE layer trains through the dispatch above: the router's gradient
comes through the renormalised top-k gates and the aux loss's mean
probabilities (the one-hot counts take none), and a dropped pair gets
none, as in the reference. Its forward has fixed shapes and no atomics,
so remat's recompute routes every token as the forward did.

Not ported: the reference's ``MOE_CONSTRAINTS`` and ``MOE_A2A`` hooks
(sharding constraints and the multi-device all-to-all dispatch of
``moe_a2a.py``; on one device the reference runs the group-local dispatch
above), ``act_spec`` and the sharding constraints (the multi-device
slice).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common import resolve_device
from repro_torch.config.base import MoEConfig, TransformerConfig
from repro_torch.kernels.flash_attention.ops import attention

Params = Dict[str, Any]

# float32 values drawn per slice of a stacked tensor at init (bounds the
# float32 scratch of the draw; the bf16 weights are the only large buffers)
_INIT_SLICE = 1 << 26


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _f32(dtype: torch.dtype) -> torch.dtype:
    """Where the reference computes in float32: float32, or float64 for
    float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> Params:
    """Stacked-layer parameter dict on ``device``: norms are ones, dense
    weights ``normal * fan_in ** -0.5`` (the embedding's fan_in is
    ``1 / 0.02**2``, std 0.02), QKV biases zero, as the reference. Each
    tensor is drawn in float32 slices of at most ``_INIT_SLICE`` values and
    cast into the model dtype, so peak memory stays near the weights'
    own."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def dense_init(fan_in, *shape):
        out = torch.empty(shape, dtype=dt, device=dev)
        flat = out.view(-1, shape[-1])
        rows = max(1, _INIT_SLICE // shape[-1])
        for r0 in range(0, flat.shape[0], rows):
            part = flat[r0:r0 + rows]
            draw = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                               device=dev)
            part.copy_(draw.mul_(fan_in ** -0.5))
        return out

    p: Params = {
        "embed": dense_init(int(1 / 0.02**2), cfg.vocab_size, d),
        "final_norm": norm_init(d),
        "layers": {
            "attn_norm": norm_init(L, d),
            "mlp_norm": norm_init(L, d),
            "wq": dense_init(d, L, d, hq * hd),
            "wk": dense_init(d, L, d, hkv * hd),
            "wv": dense_init(d, L, d, hkv * hd),
            "wo": dense_init(hq * hd, L, hq * hd, d),
        },
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p["layers"][name] = torch.zeros((L, width), dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(d, d, cfg.vocab_size)
    layers, f = p["layers"], cfg.d_ff
    if isinstance(cfg, MoEConfig):
        E = cfg.n_experts
        layers["router"] = dense_init(d, L, d, E)
        layers["w_gate"] = dense_init(d, L, E, d, f)
        layers["w_up"] = dense_init(d, L, E, d, f)
        layers["w_down"] = dense_init(f, L, E, f, d)
        if cfg.n_shared_experts:
            fs = (cfg.d_ff_shared or cfg.d_ff) * cfg.n_shared_experts
            layers["ws_gate"] = dense_init(d, L, d, fs)
            # the reference draws ws_up from ws_gate's key: the same values
            layers["ws_up"] = layers["ws_gate"].clone()
            layers["ws_down"] = dense_init(fs, L, fs, d)
    else:
        layers["w_gate"] = dense_init(d, L, d, f)
        layers["w_up"] = dense_init(d, L, d, f)
        layers["w_down"] = dense_init(f, L, f, d)
    return p


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer dict (views, no copies)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 normalisation, cast back, then times ``g`` (not ``1 + g``),
    as the reference (``transformer.py:119-122``)."""
    xf = x.to(_f32(x.dtype))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding. x ``[..., S, H, Dh]``, pos int32 ``[S]``
    (or ``[B, S]``); float32 angles, the result cast back to x's dtype."""
    dh = x.shape[-1]
    half = dh // 2
    wt = _f32(x.dtype)
    freqs = theta ** (-torch.arange(0, half, dtype=wt, device=x.device)
                      / half)
    ang = pos.to(wt)[..., None] * freqs                     # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # broadcast heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _layer_window(cfg: TransformerConfig, layer_idx: int) -> int:
    """Layer ``layer_idx``'s sliding window (0 = full attention)."""
    if cfg.local_global_alternating and cfg.sliding_window:
        # gemma2: even layers local (sliding window), odd layers global
        return cfg.sliding_window if layer_idx % 2 == 0 else 0
    return cfg.sliding_window


def _decode_attention(q, k, v, kv_len: int, window: int, softcap: float,
                      scale: float) -> torch.Tensor:
    """Single-query attention against the cache, GQA by a grouped einsum (no
    KV repeat). q ``[B, Hq, 1, D]``; k, v ``[B, Hkv, S, D]``. Plain torch
    ops, as the reference's is plain jnp."""
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)
    mask = kpos < kv_len
    if window > 0:
        mask &= kpos > (kv_len - 1 - window)
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return o.reshape(B, Hq, 1, D).to(q.dtype)


def _attention_block(x, lp, cfg: TransformerConfig, pos, kv_len: int,
                     layer_window_static: int, cache_kv=None,
                     attn_impl: str = "auto"):
    """x ``[B, S, D]``; cache_kv optional (k, v) ``[B, Hkv, Sc, Dh]`` views of
    the cache, written in place at rows ``kv_len - S .. kv_len - 1``."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = rope(q.reshape(B, S, hq, hd), pos, cfg.rope_theta)
    k = rope(k.reshape(B, S, hkv, hd), pos, cfg.rope_theta)
    v = v.reshape(B, S, hkv, hd)
    q = q.transpose(1, 2)   # [B, H, S, Dh] views
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    new_kv = (k, v)
    q_offset = None
    if cache_kv is not None:
        ck, cv = cache_kv
        start = kv_len - S
        ck[:, :, start:kv_len] = k
        cv[:, :, start:kv_len] = v
        k, v = ck, cv
        new_kv = (ck, cv)
        q_offset = start

    if cache_kv is not None and S == 1:
        # decode hot path: grouped-einsum attention in plain torch ops
        o = _decode_attention(q, k, v, kv_len, layer_window_static,
                              cfg.attn_logit_softcap, cfg.head_dim ** -0.5)
    else:
        o = attention(q, k, v, kv_len=kv_len, q_offset=q_offset,
                      causal=True, window=layer_window_static,
                      softcap=cfg.attn_logit_softcap,
                      scale=cfg.head_dim ** -0.5, impl=attn_impl)
    o = o.transpose(1, 2).reshape(B, S, hq * hd)
    return x + o @ lp["wo"], new_kv


def _dense_mlp(x, lp, cfg: TransformerConfig):
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    g = _act(h @ lp["w_gate"], cfg.act) * (h @ lp["w_up"])
    return x + g @ lp["w_down"]


def moe_route(h: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """The router of ``h`` ``[G, Tg, d]``: (float32 probabilities
    ``[G, Tg, E]``, renormalised gates ``[G, Tg, k]`` (float32), experts
    ``[G, Tg, k]`` (int64), the Switch aux loss). The top k are the first
    k of a stable descending sort, so of equal probabilities the lower
    expert index wins, as in ``lax.top_k`` (``torch.topk`` breaks ties
    otherwise)."""
    E = cfg.n_experts
    probs = torch.softmax((h @ router).to(_f32(h.dtype)), dim=-1)
    gate_vals, exp_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_vals, exp_idx = gate_vals[..., :cfg.top_k], exp_idx[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # load-balance aux loss (Switch eq. 4) over all groups; the one-hot by
    # a comparison (no bincount, no device read)
    first = exp_idx[..., :1] == torch.arange(E, device=h.device)
    aux = E * torch.sum(first.to(probs.dtype).mean(dim=(0, 1))
                        * probs.mean(dim=(0, 1)))
    return probs, gate_vals, exp_idx, aux


def moe_capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """Slots per expert and group, in the reference's Python arithmetic:
    ``ceil(Tg k / E cf)`` when a group has at least E tokens, else ``Tg``;
    then at least 4."""
    Tg, k, E = tokens_per_group, cfg.top_k, cfg.n_experts
    capacity = (math.ceil(Tg * k / E * cfg.capacity_factor) if Tg >= E
                else Tg)
    return max(capacity, 4)


def moe_dispatch(exp_idx: torch.Tensor, gate_vals: torch.Tensor,
                 capacity: int, n_experts: int):
    """Each (token, choice) pair's place, group by group, for experts
    ``[G, Tg, k]``: its position among its expert's pairs in (token,
    choice) order, from a stable sort and ``searchsorted``. Returns
    (expert ``[G, Tg k]``, slot, gate, keep): pairs at positions past the
    capacity are dropped, with gate 0 and slot ``capacity - 1``."""
    G, Tg, k = exp_idx.shape
    flat_e = exp_idx.reshape(G, Tg * k)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(n_experts, dtype=flat_e.dtype,
                           device=flat_e.device)
    seg_start = torch.searchsorted(sorted_e,
                                   experts.expand(G, n_experts).contiguous())
    pos_sorted = (torch.arange(Tg * k, device=flat_e.device)
                  - seg_start.gather(1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < capacity
    gate = gate_vals.reshape(G, Tg * k) * keep
    slot = torch.where(keep, pos, capacity - 1)
    return flat_e, slot, gate, keep


def _moe_ffn(h: torch.Tensor, lp: Params,
             cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on the normalised tokens ``h`` ``[G, Tg, d]`` (model
    dtype): (float32 output ``[G, Tg, d]`` before the residual add, aux)."""
    G, Tg, d = h.shape
    E, k = cfg.n_experts, cfg.top_k
    _, gate_vals, exp_idx, aux = moe_route(h, lp["router"], cfg)
    C = moe_capacity(Tg, cfg)
    flat_e, slot, gate, keep = moe_dispatch(exp_idx, gate_vals, C, E)
    # row of each pair in the flat [E, G, C] slot buffer; dropped pairs are
    # written to one extra row past its end and read back from slot C - 1
    # (gate 0), as the reference's
    group = torch.arange(G, device=h.device)[:, None]
    row = (flat_e * G + group) * C + slot                     # [G, Tg k]
    dest = torch.where(keep, row, E * G * C)
    # The dropped pairs all land on the extra row, in an order left
    # undefined. No product reads that row, so its gradient is zero and a
    # dropped pair's token gets none through the copy, as the reference's
    # multiply by keep gives it none. The source is a [T k, d] copy of h.
    x_disp = h.new_zeros((E * G * C + 1, d))
    x_disp.index_copy_(0, dest.reshape(-1),
                       h[:, :, None].expand(G, Tg, k, d).reshape(-1, d))
    xe = x_disp[:E * G * C].view(E, G * C, d)
    gu = _act(torch.bmm(xe, lp["w_gate"]), cfg.act) * torch.bmm(xe,
                                                                lp["w_up"])
    y = torch.bmm(gu, lp["w_down"]).view(E * G * C, d)
    # The combine gathers by index_select, whose backward is index_add_
    # into y's rows: a kept pair owns its slot, so a slot gets that one
    # pair's gradient, and a dropped pair reads slot C - 1 with gate 0 and
    # adds an exact zero. So the sum is exact, the same in any order of
    # the card's atomics. bf16 x float32 promotes to float32, as in JAX.
    y_tok = (y.index_select(0, row.reshape(-1)).view(G, Tg * k, d)
             * gate[..., None])
    out = y_tok.view(G, Tg, k, d).sum(dim=2)
    if cfg.n_shared_experts:
        gs = _act(h @ lp["ws_gate"], cfg.act) * (h @ lp["ws_up"])
        out = out + gs @ lp["ws_down"]
    return out, aux


def _moe_mlp(x: torch.Tensor, lp: Params,
             cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE with group-local dispatch: ``cfg.moe_groups``
    groups of consecutive tokens (1 when 0 or when it does not divide the
    token count), each routed into its own capacity buffer. Returns
    (``x`` plus the FFN output cast to x's dtype, aux loss)."""
    B, S, d = x.shape
    G = cfg.moe_groups or 1
    if (B * S) % G:
        G = 1
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps).reshape(G, B * S // G, d)
    out, aux = _moe_ffn(h, lp, cfg)
    return x + out.reshape(B, S, d).to(x.dtype), aux


def _mlp(x, lp, cfg: TransformerConfig):
    """The layer's FFN: (output, aux loss), aux ``None`` for a dense one."""
    if isinstance(cfg, MoEConfig):
        return _moe_mlp(x, lp, cfg)
    return _dense_mlp(x, lp, cfg), None


def _embed(params: Params, tokens: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    # the scale is rounded to the model dtype before the multiply, as the
    # reference's jnp.asarray(d ** 0.5, dtype) (sqrt(3584) -> 59.75 in bf16);
    # the product of two model-dtype values is then rounded once, as there.
    # A host scalar, so no step copies to the device.
    # sync: a CPU tensor; rounds a host scalar to the model dtype
    scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=_dtype(cfg)))
    return params["embed"][tokens] * scale


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig,
                   attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone only: (hidden ``[B, S, D]`` after the final norm, the MoE
    aux loss averaged over the layers; 0 for a dense config). With
    ``cfg.remat != "none"`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint``."""
    _, S = tokens.shape
    x = _embed(params, tokens, cfg)
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    aux = torch.zeros((), dtype=_f32(x.dtype), device=x.device)
    slices = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def layer(x, i):
        lp = {k: v[i] for k, v in slices.items()}
        x, _ = _attention_block(x, lp, cfg, pos, S, _layer_window(cfg, i),
                                attn_impl=attn_impl)
        x, a = _mlp(x, lp, cfg)
        return (x,) if a is None else (x, a)

    for i in range(cfg.n_layers):
        out = (checkpoint(layer, x, i, use_reentrant=False,
                          preserve_rng_state=False) if remat
               else layer(x, i))
        x = out[0]
        if len(out) > 1:
            aux = aux + out[1] / cfg.n_layers
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _unembed_logits(params: Params, x: torch.Tensor,
                    cfg: TransformerConfig) -> torch.Tensor:
    """A product in the model dtype, then float32, then the final softcap:
    in place where autograd does not record (at gemma2-9b's S = 8192 the
    float32 logits are 8.4 GB), out of place where it does (``tanh``'s
    backward reads its output)."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ unembed).to(_f32(x.dtype))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        if torch.is_grad_enabled() and logits.requires_grad:
            logits = torch.tanh(logits / c) * c
        else:
            logits.div_(c).tanh_().mul_(c)
    return logits


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward with logits (prefill / small shapes)."""
    x, aux = forward_hidden(params, tokens, cfg, attn_impl=attn_impl)
    return _unembed_logits(params, x, cfg), aux


def _chunk_nll(params: Params, x_c: torch.Tensor, labels_c: torch.Tensor,
               cfg: TransformerConfig):
    """One chunk's summed NLL and its count of unmasked labels."""
    logits = _unembed_logits(params, x_c, cfg)       # [B, S_c, V]
    mask = labels_c >= 0
    lab = torch.where(mask, labels_c, 0).to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, attn_impl: str = "auto",
            loss_chunks: int = 0) -> torch.Tensor:
    """Next-token cross-entropy, chunked over the sequence as the
    reference's (``transformer.py:462-505``): ``n_chunks = loss_chunks or
    cfg.loss_chunks or (8 if S >= 2048 else 1)``, lowered until it divides
    S; each chunk's ``[B, S_c, V]`` float32 logits are made, reduced to its
    NLL and freed, and made again in the backward
    (``torch.utils.checkpoint``), so the full logits never exist. Labels
    ``-1`` are masked. An MoE config adds ``router_aux_loss`` times the
    layers' mean aux loss."""
    x, aux = forward_hidden(params, batch["tokens"], cfg,
                            attn_impl=attn_impl)
    labels = batch["labels"]
    B, S = labels.shape
    n_chunks = loss_chunks or cfg.loss_chunks or (8 if S >= 2048 else 1)
    while S % n_chunks:
        n_chunks -= 1
    sc = S // n_chunks
    tot = torch.zeros((), dtype=_f32(x.dtype), device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * sc, (c + 1) * sc)
        args = (params, x[:, sl], labels[:, sl], cfg)
        t, n = (checkpoint(_chunk_nll, *args, use_reentrant=False,
                           preserve_rng_state=False)
                if torch.is_grad_enabled() else _chunk_nll(*args))
        tot, cnt = tot + t, cnt + n
    loss = tot / torch.clamp_min(cnt, 1)
    if isinstance(cfg, MoEConfig):
        loss = loss + cfg.router_aux_loss * aux
    return loss


def prefill_step(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig,
                 attn_impl: str = "auto") -> torch.Tensor:
    """Serve prefill: the full-sequence forward, float32 logits
    ``[B, S, V]``."""
    with torch.inference_mode():
        logits, _ = forward(params, tokens, cfg, attn_impl=attn_impl)
    return logits


# ---------------------------------------------------------------------------
# serving: KV-cache decode
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> Params:
    """``[L, B, Hkv, S, Dh]`` stacked zero cache and its length 0."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "len": 0}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: TransformerConfig,
                attn_impl: str = "auto") -> Tuple[torch.Tensor, Params]:
    """One serve step: append the newest token (int ``[B, 1]``) to the cache
    in place, attend to it, and return (float32 logits ``[B, V]``, the
    cache with ``len`` one larger)."""
    new_len = cache["len"] + 1
    if new_len > cache["k"].shape[3]:
        raise ValueError(f"decode_step: cache of {cache['k'].shape[3]} "
                         f"positions is full")
    with torch.inference_mode():
        x = _embed(params, tokens, cfg)
        pos = torch.full((1,), new_len - 1, dtype=torch.int32,
                         device=tokens.device)
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            x, _ = _attention_block(
                x, lp, cfg, pos, new_len, _layer_window(cfg, i),
                cache_kv=(cache["k"][i], cache["v"][i]), attn_impl=attn_impl)
            x, _ = _mlp(x, lp, cfg)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = _unembed_logits(params, x, cfg)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "len": new_len}

"""Decoder-only transformer, dense path: the port of the JAX package's
``models/transformer.py`` for serving (gemma2-9b and the other dense archs
once their configs are ported).

Parameters are a plain dict with layers STACKED on a leading ``[L]`` axis,
as in the reference (``embed``, ``final_norm``, optional ``unembed``, and
``layers`` with ``attn_norm``, ``mlp_norm``, ``wq``, ``wk``, ``wv``, ``wo``,
optional ``bq``/``bk``/``bv``, ``w_gate``, ``w_up``, ``w_down``). Attention
tensors are ``[B, H, S, D]`` and the KV cache is ``[L, B, Hkv, S, D]``.

Where it differs from the reference, on purpose:
  * the layers run as a Python loop with each layer's window static (the
    reference's unrolled branch, ``transformer.py:428-440``), since eager
    PyTorch has no ``lax.scan``;
  * attention goes through ``kernels/flash_attention/ops.attention``: the
    hand-written CUDA kernel for CUDA tensors, the plain version for CPU
    tensors (``attn_impl="ref"`` forces the plain version anywhere);
  * ``decode_step`` writes the new K/V row into the cache in place and
    returns the same tensors; the cache length ``"len"`` is a Python int
    (the serving loop knows it), so no step reads the device;
  * ``init_params`` draws from a seeded ``torch.Generator`` on the device,
    one slice at a time: the values differ from the reference's
    ``jax.random`` init (tests carry the reference's weights over with
    ``convert.transformer_params_from_reference``).
Not yet ported: the MoE FFN and its all-to-all, ``lm_loss``, remat and the
sharding constraints (the training and MoE slices).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device
from repro_torch.config.base import TransformerConfig
from repro_torch.kernels.flash_attention.ops import attention

Params = Dict[str, Any]

# float32 values drawn per slice of a stacked tensor at init (bounds the
# float32 scratch of the draw; the bf16 weights are the only large buffers)
_INIT_SLICE = 1 << 26


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    f = cfg.d_ff
    p["layers"]["w_gate"] = dense_init(d, L, d, f)
    p["layers"]["w_up"] = dense_init(d, L, d, f)
    p["layers"]["w_down"] = dense_init(f, L, f, d)
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
    xf = x.float()
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
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(torch.float32)[..., None] * freqs          # [..., S, half]
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


def _embed(params: Params, tokens: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    # the scale is rounded to the model dtype before the multiply, as the
    # reference's jnp.asarray(d ** 0.5, dtype) (sqrt(3584) -> 59.75 in bf16);
    # the product of two model-dtype values is then rounded once, as there.
    # A host scalar, so no step copies to the device.
    scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=_dtype(cfg)))
    return params["embed"][tokens] * scale


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig,
                   attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone only: (hidden ``[B, S, D]`` after the final norm, aux loss
    0 for the dense path)."""
    _, S = tokens.shape
    x = _embed(params, tokens, cfg)
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x, _ = _attention_block(x, lp, cfg, pos, S, _layer_window(cfg, i),
                                attn_impl=attn_impl)
        x = _dense_mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _unembed_logits(params: Params, x: torch.Tensor,
                    cfg: TransformerConfig) -> torch.Tensor:
    """A product in the model dtype, then float32, then the final softcap
    (in place: at gemma2-9b's S = 8192 the float32 logits are 8.4 GB)."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ unembed).float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits.div_(c).tanh_().mul_(c)
    return logits


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward with logits (prefill / small shapes)."""
    x, aux = forward_hidden(params, tokens, cfg, attn_impl=attn_impl)
    return _unembed_logits(params, x, cfg), aux


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
            x = _dense_mlp(x, lp, cfg)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = _unembed_logits(params, x, cfg)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "len": new_len}

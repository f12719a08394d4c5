"""Copies of the JAX package's ``config/base.py`` dataclasses that the
ported LM path reads: ``ArchConfig`` and ``TransformerConfig`` (with
``head_dim`` and ``param_count``). The MoE, GNN and recsys configs wait for
their slices.

Configs are plain frozen dataclasses: hashable, serialisable with
``dataclasses.asdict`` and overridable with ``dataclasses.replace``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str = "base"
    family: str = "base"  # lm | gnn | recsys | graph

    def param_count(self) -> int:  # overridden per family
        return 0


@dataclass(frozen=True)
class TransformerConfig(ArchConfig):
    family: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_head: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024
    # attention variants
    sliding_window: int = 0          # 0 = full attention on every layer
    local_global_alternating: bool = False  # gemma2: even layers local(SW), odd global
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10000.0
    max_position: int = 131072
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"                # swiglu gate act ("gelu" for gemma2)
    dtype: str = "bfloat16"
    # remat / scan (read by the reference's training path; kept so configs
    # compare field for field)
    remat: str = "none"              # none | full | dots_saveable
    scan_layers: bool = True
    loss_chunks: int = 0             # CE chunking (0 = auto: 8 when S>=2k)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    def param_count(self) -> int:
        d, h = self.d_model, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

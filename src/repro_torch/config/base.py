"""Copies of the JAX package's ``config/base.py`` dataclasses that the
ported paths read: ``ShapeSpec``, ``ArchConfig``, ``TransformerConfig``
(with ``head_dim`` and ``param_count``), ``MoEConfig`` (with
``param_count`` and ``active_param_count``), ``GNNConfig`` (with the
reference's rough ``param_count``), ``RecsysConfig`` (with ``param_count`` as the reference
has it: it leaves out the ``linear`` table), ``GraphEngineConfig`` (the
paper engine's, without the sharded and Pallas backends' knobs ``comm``,
``relax_impl``, ``node_tile`` and ``edge_block``; its ``backend`` defaults
to the port's ``kernel``), ``TrainConfig`` (value for value), the shape
sets ``LM_SHAPES``, ``GNN_SHAPES``
and ``RECSYS_SHAPES``, and ``shapes_for_family``.

``TransformerConfig.param_count()`` is the reference's: it leaves out the
QKV biases (qwen1.5-32b: 983,040 elements over 64 layers), so it equals
the elements ``init_params`` makes (``unembed`` included where the
embeddings are untied) only where there are no biases.

Configs are plain frozen dataclasses: hashable, serialisable with
``dataclasses.asdict`` and overridable with ``dataclasses.replace``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture, as the reference's.

    ``kind`` selects the regime: "train" / "prefill" / "decode" (LM),
    "full_graph" / "minibatch" / "batched_graphs" (GNN) or "recsys_train"
    / "recsys_serve" / "retrieval" (recsys).
    """

    name: str
    kind: str
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # GNN fields
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys fields
    batch: int = 0
    n_candidates: int = 0


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


@dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    """Mixture-of-experts transformer (mixtral / moonlight style)."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25    # slots per expert vs perfect balance
    moe_groups: int = 0              # dispatch groups (0 -> 1): tokens are
                                     # routed into group-local capacity
                                     # buffers (models/transformer.py)
    n_shared_experts: int = 0        # moonlight: shared expert(s) always active
    d_ff_shared: int = 0             # width of shared expert (0 -> d_ff)
    moe_every: int = 1               # MoE layer every k-th layer (1 = all layers)
    router_aux_loss: float = 0.01

    def param_count(self) -> int:
        d, h = self.d_model, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        moe = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
        shared = 3 * d * (self.d_ff_shared or self.d_ff) * self.n_shared_experts
        per_layer = attn + moe + shared + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    def active_param_count(self) -> int:
        d, h = self.d_model, self.head_dim
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        moe = 3 * d * self.d_ff * self.top_k + d * self.n_experts
        shared = 3 * d * (self.d_ff_shared or self.d_ff) * self.n_shared_experts
        per_layer = attn + moe + shared + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d


@dataclass(frozen=True)
class GNNConfig(ArchConfig):
    family: str = "gnn"
    kind: str = "gcn"                # gcn | gatedgcn | meshgraphnet | equiformer_v2
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 0                    # input feature dim (0 -> shape-provided)
    d_out: int = 7                   # output classes / targets
    aggregator: str = "mean"         # mean | sum | max | gated
    norm: str = "sym"                # sym | none (GCN adjacency normalization)
    mlp_layers: int = 2              # meshgraphnet per-block MLP depth
    d_edge: int = 0                  # edge feature dim (0 -> none)
    # equiformer-v2 fields
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    dtype: str = "float32"
    residual: bool = False

    def param_count(self) -> int:
        d = self.d_hidden
        return self.n_layers * (3 * d * d + 2 * d)  # rough; exact per model


@dataclass(frozen=True)
class RecsysConfig(ArchConfig):
    family: str = "recsys"
    kind: str = "xdeepfm"
    n_sparse: int = 39
    n_dense: int = 13                 # criteo-style numeric features
    embed_dim: int = 10
    vocab_per_field: int = 100_000    # embedding rows per sparse field
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp_dims: Tuple[int, ...] = (400, 400)
    multi_hot: int = 1                # ids per field (embedding-bag degree)
    dtype: str = "float32"

    def param_count(self) -> int:
        emb = self.n_sparse * self.vocab_per_field * self.embed_dim
        m = self.n_sparse
        cin = 0
        prev = m
        for hk in self.cin_layers:
            cin += hk * prev * m
            prev = hk
        mlp_in = self.n_sparse * self.embed_dim + self.n_dense
        mlp = 0
        prev = mlp_in
        for w in self.mlp_dims:
            mlp += prev * w + w
            prev = w
        return emb + cin + mlp + prev + sum(self.cin_layers) + 1


@dataclass(frozen=True)
class GraphEngineConfig(ArchConfig):
    """Config for the paper's decomposition/diameter engine."""

    family: str = "graph"
    tau_fraction: float = 1e-3   # tau ~ n * tau_fraction / log n
    gamma: float = 2.0           # center-sampling constant
    variant: str = "stop"        # stop | complete (paper Table 2)
    delta_init: str = "avg"      # avg | min | <int>
    max_stages: int = 64
    max_steps_per_phase: int = 0  # 0 -> 2n/tau (paper's num_it)
    use_cluster2: bool = False   # paper Algorithm 2 instead of CLUSTER
                                 # (staged only; core/cluster.cluster2)
    seed: int = 0
    backend: str = "kernel"      # single | kernel (core/backend.py)
    autotune: str = "off"        # off | auto | record (core/autotune.py)
    fuse_supersteps: int = 0     # kernel backend: supersteps per megakernel
                                 # launch (0 = unfused unless the autotuner
                                 # engages)
    mode: str = "stages"         # stages | oneshot | auto (core/engine.py;
                                 # "auto" defers to the autotuning record,
                                 # "stages" without one)
    deterministic: bool = False  # oneshot: hash-derived centers and shifts


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    zero1: bool = True                # shard optimizer state over data axis
    grad_compression: str = "none"    # none | int8_ef
    log_every: int = 10


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    ShapeSpec(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="full_graph_sm", kind="full_graph", n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeSpec(
        name="minibatch_lg",
        kind="minibatch",
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanout=(15, 10),
        d_feat=602,
    ),
    ShapeSpec(name="ogb_products", kind="full_graph", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    ShapeSpec(name="molecule", kind="batched_graphs", n_nodes=30, n_edges=64, n_graphs=128, d_feat=32),
)

RECSYS_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="train_batch", kind="recsys_train", batch=65536),
    ShapeSpec(name="serve_p99", kind="recsys_serve", batch=512),
    ShapeSpec(name="serve_bulk", kind="recsys_serve", batch=262144),
    ShapeSpec(name="retrieval_cand", kind="retrieval", batch=1, n_candidates=1_000_000),
)


def shapes_for_family(family: str) -> Tuple[ShapeSpec, ...]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[family]

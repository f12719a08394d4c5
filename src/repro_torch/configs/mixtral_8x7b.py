"""mixtral-8x7b [arXiv:2401.04088]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.config.base import MoEConfig
from repro_torch.config.registry import register_arch


def full() -> MoEConfig:
    return MoEConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab_size=32000,
        n_experts=8, top_k=2, sliding_window=4096,
        act="silu", rope_theta=1_000_000.0, dtype="bfloat16", remat="full",
    )


def smoke() -> MoEConfig:
    return MoEConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=96, vocab_size=512, n_experts=4, top_k=2, capacity_factor=16.0,
        sliding_window=16, dtype="float32",
    )


register_arch("mixtral-8x7b", full, smoke)

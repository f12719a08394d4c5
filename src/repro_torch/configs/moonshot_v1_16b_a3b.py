"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (kv=16) expert d_ff=1408 vocab=163840, MoE 64 experts top-6 + 2 shared
experts (DeepSeek-V3-style fine-grained MoE)."""
from repro_torch.config.base import MoEConfig
from repro_torch.config.registry import register_arch


def full() -> MoEConfig:
    return MoEConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=1408, vocab_size=163840,
        n_experts=64, top_k=6, n_shared_experts=2, d_ff_shared=1408,
        act="silu", rope_theta=50000.0, dtype="bfloat16", remat="full",
    )


def smoke() -> MoEConfig:
    return MoEConfig(
        name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=48, vocab_size=512, n_experts=8, top_k=3, capacity_factor=16.0,
        n_shared_experts=1, d_ff_shared=48, dtype="float32",
    )


register_arch("moonshot-v1-16b-a3b", full, smoke)

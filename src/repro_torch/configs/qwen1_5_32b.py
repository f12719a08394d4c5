"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B family]: 64L d_model=5120 40H
(GQA kv=40 = MHA) d_ff=27392 vocab=152064 — QKV bias, SwiGLU."""
from repro_torch.config.base import TransformerConfig
from repro_torch.config.registry import register_arch


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_head=128, d_ff=27392, vocab_size=152064,
        qkv_bias=True, act="silu", rope_theta=1_000_000.0,
        dtype="bfloat16", remat="full",
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-32b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=160, vocab_size=512, qkv_bias=True, dtype="float32",
    )


register_arch("qwen1.5-32b", full, smoke)

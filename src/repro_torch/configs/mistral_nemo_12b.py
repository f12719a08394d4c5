"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]: 40L d_model=5120
32H (GQA kv=8) d_ff=14336 vocab=131072 — 128k context, head_dim 128."""
from repro_torch.config.base import TransformerConfig
from repro_torch.config.registry import register_arch


def full() -> TransformerConfig:
    return TransformerConfig(
        name="mistral-nemo-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab_size=131072,
        act="silu", rope_theta=1_000_000.0, max_position=131072,
        dtype="bfloat16", remat="full",
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="mistral-nemo-12b-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=128, vocab_size=512, dtype="float32",
    )


register_arch("mistral-nemo-12b", full, smoke)

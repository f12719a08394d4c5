"""gemma2-9b [arXiv:2408.00118; hf]: 42L d_model=3584 16H (GQA kv=8)
d_ff=14336 vocab=256000 — local+global alternating sliding window (4096),
attn logit softcap 50, final logit softcap 30, GeGLU, head_dim 256."""
from repro_torch.config.base import TransformerConfig
from repro_torch.config.registry import register_arch


def full() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        d_head=256, d_ff=14336, vocab_size=256000,
        sliding_window=4096, local_global_alternating=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        act="gelu", rope_theta=10000.0, tie_embeddings=True,
        dtype="bfloat16", remat="full",
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-9b-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab_size=512,
        sliding_window=16, local_global_alternating=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        act="gelu", tie_embeddings=True, dtype="float32",
    )


register_arch("gemma2-9b", full, smoke)

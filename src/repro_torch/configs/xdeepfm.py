"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, DNN 400-400. Tables sized 10^6 rows/field (the huge-
embedding axis of the recsys family)."""
from repro_torch.config.base import RecsysConfig
from repro_torch.config.registry import register_arch


def full() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm", n_sparse=39, n_dense=13, embed_dim=10,
        vocab_per_field=1_000_000, cin_layers=(200, 200, 200),
        mlp_dims=(400, 400), multi_hot=1,
    )


def smoke() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm-smoke", n_sparse=6, n_dense=4, embed_dim=8,
        vocab_per_field=1000, cin_layers=(16, 16), mlp_dims=(32, 16),
        multi_hot=2,
    )


register_arch("xdeepfm", full, smoke)

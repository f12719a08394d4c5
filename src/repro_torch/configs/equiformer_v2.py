"""equiformer-v2 [arXiv:2306.12059]: 12 blocks, d_hidden=128, l_max=6,
m_max=2, 8 heads — SO(2)-eSCN equivariant graph attention."""
from repro_torch.config.base import GNNConfig
from repro_torch.config.registry import register_arch


def full() -> GNNConfig:
    return GNNConfig(name="equiformer-v2", kind="equiformer_v2", n_layers=12,
                     d_hidden=128, l_max=6, m_max=2, n_heads=8, d_out=1)


def smoke() -> GNNConfig:
    return GNNConfig(name="equiformer-v2-smoke", kind="equiformer_v2",
                     n_layers=2, d_hidden=16, l_max=3, m_max=2, n_heads=4,
                     d_out=1)


register_arch("equiformer-v2", full, smoke)

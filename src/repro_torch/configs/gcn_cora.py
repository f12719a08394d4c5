"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean/sym-norm
aggregation — the canonical citation-network GCN."""
from repro_torch.config.base import GNNConfig
from repro_torch.config.registry import register_arch


def full() -> GNNConfig:
    return GNNConfig(name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16,
                     aggregator="mean", norm="sym", d_out=7)


def smoke() -> GNNConfig:
    return GNNConfig(name="gcn-smoke", kind="gcn", n_layers=2, d_hidden=8,
                     aggregator="mean", norm="sym", d_out=4)


register_arch("gcn-cora", full, smoke)

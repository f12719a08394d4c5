"""gatedgcn [arXiv:2003.00982 benchmarking-gnns]: 16 layers, d_hidden=70,
edge-gated aggregation with residuals + norms."""
from repro_torch.config.base import GNNConfig
from repro_torch.config.registry import register_arch


def full() -> GNNConfig:
    return GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                     d_hidden=70, aggregator="gated", d_out=7, d_edge=1)


def smoke() -> GNNConfig:
    return GNNConfig(name="gatedgcn-smoke", kind="gatedgcn", n_layers=3,
                     d_hidden=16, aggregator="gated", d_out=4, d_edge=1)


register_arch("gatedgcn", full, smoke)

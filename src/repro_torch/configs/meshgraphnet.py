"""meshgraphnet [arXiv:2010.03409]: 15 message-passing blocks, d_hidden=128,
sum aggregation, 2-layer MLPs, encode-process-decode."""
from repro_torch.config.base import GNNConfig
from repro_torch.config.registry import register_arch


def full() -> GNNConfig:
    return GNNConfig(name="meshgraphnet", kind="meshgraphnet", n_layers=15,
                     d_hidden=128, aggregator="sum", mlp_layers=2, d_out=3,
                     d_edge=4)


def smoke() -> GNNConfig:
    return GNNConfig(name="meshgraphnet-smoke", kind="meshgraphnet",
                     n_layers=2, d_hidden=32, aggregator="sum", mlp_layers=2,
                     d_out=3, d_edge=4)


register_arch("meshgraphnet", full, smoke)

"""paper-graph: the paper's own decomposition/diameter engine as an arch.
Defaults are the paper's experimental choices (CLUSTER, the stop variant,
Delta_init = the average edge weight, a quotient of about n/1000)."""
from repro_torch.config.base import GraphEngineConfig
from repro_torch.config.registry import register_arch


def full() -> GraphEngineConfig:
    return GraphEngineConfig(name="paper-graph")


def smoke() -> GraphEngineConfig:
    return GraphEngineConfig(name="paper-graph-smoke", tau_fraction=2e-2,
                             max_stages=16)


register_arch("paper-graph", full, smoke)

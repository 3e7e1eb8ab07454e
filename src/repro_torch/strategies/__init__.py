"""Aggregation strategies: the protocol, the registry, and the paper's
ColRel with its FedAvg baselines.  Importing this package registers them::

    from repro_torch import strategies

    strategies.available()   # ('colrel', 'fedavg_blind', ...)
    s = strategies.get("colrel", fused="kernel")
"""

from repro_torch.strategies.base import AggregationStrategy, ExecutionContext
from repro_torch.strategies.registry import available, get, register, resolve
from repro_torch.strategies.classic import (
    ColRelStrategy,
    FedAvgBlind,
    FedAvgNonBlind,
    FedAvgPerfect,
)

__all__ = [
    "AggregationStrategy",
    "ExecutionContext",
    "available",
    "get",
    "register",
    "resolve",
    "ColRelStrategy",
    "FedAvgBlind",
    "FedAvgNonBlind",
    "FedAvgPerfect",
]

"""Aggregation strategies: the protocol, the registry, the paper's ColRel
with its FedAvg baselines, the block-sparse ``clustered`` ColRel, the
replay-buffer ``memory`` scheme and the codec-wrapped ``quantized``
scheme.  Importing this package registers them::

    from repro_torch import strategies

    strategies.available()   # ('clustered', 'colrel', ..., 'memory', 'quantized')
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
from repro_torch.strategies.clustered import ClusteredColRelStrategy
from repro_torch.strategies.memory import MemoryStrategy
from repro_torch.strategies.quantized import QuantizedStrategy

__all__ = [
    "AggregationStrategy",
    "ExecutionContext",
    "available",
    "get",
    "register",
    "resolve",
    "ClusteredColRelStrategy",
    "ColRelStrategy",
    "FedAvgBlind",
    "FedAvgNonBlind",
    "FedAvgPerfect",
    "MemoryStrategy",
    "QuantizedStrategy",
]

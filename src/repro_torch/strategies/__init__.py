"""Aggregation strategies: the protocol, the registry, the paper's ColRel
with its FedAvg baselines, the block-sparse ``clustered`` ColRel, the
replay-buffer ``memory`` scheme, the codec-wrapped ``quantized``
scheme, K-hop ``multihop`` relaying and the staleness-weighted
``async_colrel``.  Importing this package registers them::

    from repro_torch import strategies

    strategies.available()   # ('async_colrel', 'clustered', 'colrel', ..., 'quantized')
    s = strategies.get("colrel", fused="kernel")

The deprecated ``colrel_fused`` alias and ``resolve(..., fused_kernel=True)``
warn and forward to ``colrel``'s ``fused`` option.
"""

from repro_torch.strategies.base import AggregationStrategy, ExecutionContext
from repro_torch.strategies.registry import (
    available,
    canonical_name,
    get,
    register,
    register_deprecated_alias,
    resolve,
)
from repro_torch.strategies.classic import (
    ColRelStrategy,
    FedAvgBlind,
    FedAvgNonBlind,
    FedAvgPerfect,
)
from repro_torch.strategies.clustered import ClusteredColRelStrategy
from repro_torch.strategies.memory import MemoryStrategy
from repro_torch.strategies.multihop import MultiHopStrategy, multihop_correction
from repro_torch.strategies.quantized import QuantizedStrategy
from repro_torch.strategies.async_relay import AsyncRelayStrategy, delivered_mask

__all__ = [
    "AggregationStrategy",
    "AsyncRelayStrategy",
    "ExecutionContext",
    "available",
    "canonical_name",
    "get",
    "register",
    "register_deprecated_alias",
    "resolve",
    "ClusteredColRelStrategy",
    "ColRelStrategy",
    "FedAvgBlind",
    "FedAvgNonBlind",
    "FedAvgPerfect",
    "MemoryStrategy",
    "MultiHopStrategy",
    "QuantizedStrategy",
    "delivered_mask",
    "multihop_correction",
]

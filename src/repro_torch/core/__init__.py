"""ColRel core: connectivity models, topologies and COPT-alpha (numpy,
copied from ``repro.core``), plus the flatten plumbing and the relay
algebra on tensors, dense (:mod:`.relay`) and blocked by cluster
(:mod:`.blocks`)."""

from .blocks import (
    ClusteredLinkModel,
    ClusterSpec,
    block_colrel_round_delta,
    block_effective_weights,
    block_relay_mix,
)
from .connectivity import LinkModel
from .weights import (
    ClusteredOptResult,
    OptResult,
    is_unbiased_clustered,
    optimize_weights,
    optimize_weights_clustered,
    unbiasedness_residual_clustered,
)

__all__ = [
    "LinkModel",
    "ClusterSpec",
    "ClusteredLinkModel",
    "block_relay_mix",
    "block_effective_weights",
    "block_colrel_round_delta",
    "optimize_weights",
    "optimize_weights_clustered",
    "unbiasedness_residual_clustered",
    "is_unbiased_clustered",
    "OptResult",
    "ClusteredOptResult",
]

"""ColRel core: connectivity models, topologies, the variance functional
S / Sbar and COPT-alpha (numpy, copied from ``repro.core``), plus the
flatten plumbing and the relay algebra on tensors, dense (:mod:`.relay`)
and blocked by cluster (:mod:`.blocks`), and the legacy
:class:`Aggregation` entry point (:mod:`.aggregation`)."""

from .connectivity import (
    LinkModel,
    effective_weights,
    reciprocity_matrix,
    sample_round,
    sample_rounds,
)
from .blocks import (
    ClusteredLinkModel,
    ClusterSpec,
    block_colrel_round_delta,
    block_effective_weights,
    block_relay_mix,
)
from .weights import (
    ClusteredOptResult,
    OptResult,
    fedavg_weights,
    importance_weights,
    initial_weights,
    is_unbiased,
    is_unbiased_clustered,
    optimize_weights,
    optimize_weights_clustered,
    unbiasedness_residual,
    unbiasedness_residual_clustered,
    variance_S,
    variance_Sbar,
)
from .aggregation import Aggregation, aggregate
from . import blocks, flatten, relay, topology

__all__ = [
    "LinkModel",
    "ClusterSpec",
    "ClusteredLinkModel",
    "block_relay_mix",
    "block_effective_weights",
    "block_colrel_round_delta",
    "reciprocity_matrix",
    "sample_round",
    "sample_rounds",
    "effective_weights",
    "variance_S",
    "variance_Sbar",
    "unbiasedness_residual",
    "is_unbiased",
    "initial_weights",
    "fedavg_weights",
    "importance_weights",
    "optimize_weights",
    "optimize_weights_clustered",
    "unbiasedness_residual_clustered",
    "is_unbiased_clustered",
    "OptResult",
    "ClusteredOptResult",
    "Aggregation",
    "aggregate",
    "blocks",
    "flatten",
    "relay",
    "topology",
]

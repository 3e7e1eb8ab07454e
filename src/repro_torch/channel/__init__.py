"""Connectivity processes: the paper's i.i.d. channel, the
Gilbert–Elliott bursty-blockage chains (dense and in clustered block
form) and random-waypoint mobility over the mmWave geometry; and the
online link estimator with the adaptive COPT-alpha schedule it feeds."""

from repro_torch.channel.base import (
    BlockBufferedChannel,
    StaticChannel,
    pair_lane_table,
    stacked_trace,
)
from repro_torch.channel.clustered import (
    ClusteredGEParams,
    ClusteredMarkovChannel,
    ClusteredStaticChannel,
    gilbert_elliott_clustered,
)
from repro_torch.channel.markov import (
    GEParams,
    MarkovChannel,
    gilbert_elliott,
    sample_ge_rounds_host,
)
from repro_torch.channel.estimator import LinkEstimator
from repro_torch.channel.mobility import MobilityChannel
from repro_torch.channel.schedule import AdaptiveConfig, AdaptiveWeightSchedule

__all__ = [
    "BlockBufferedChannel",
    "StaticChannel",
    "pair_lane_table",
    "stacked_trace",
    "ClusteredGEParams",
    "ClusteredMarkovChannel",
    "ClusteredStaticChannel",
    "gilbert_elliott_clustered",
    "GEParams",
    "MarkovChannel",
    "gilbert_elliott",
    "sample_ge_rounds_host",
    "MobilityChannel",
    "LinkEstimator",
    "AdaptiveConfig",
    "AdaptiveWeightSchedule",
]

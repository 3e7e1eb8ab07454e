"""Connectivity processes: the paper's i.i.d. channel, the
Gilbert–Elliott bursty-blockage chains (dense and in clustered block
form) and random-waypoint mobility over the mmWave geometry; and the
online link estimator with the adaptive COPT-alpha schedule it feeds.

One protocol, :class:`ChannelProcess`: ``tau_for_round(r)`` gives the
realized ``(tau_up (n,), tau_dd (n, n))`` a round consumes, ``trace`` the
same stream in bulk, ``model_for_round(r)`` the oracle marginals.  The
``*_scan_sampler`` functions draw rounds on the device inside a captured
round; :func:`sample_ge_rounds` draws a whole GE trace there in one call.
"""

from repro_torch.channel.base import (
    BlockBufferedChannel,
    ChannelProcess,
    StaticChannel,
    pair_lane_table,
    stacked_trace,
    static_scan_sampler,
)
from repro_torch.channel.clustered import (
    ClusteredGEParams,
    ClusteredMarkovChannel,
    ClusteredStaticChannel,
    clustered_ge_scan_sampler,
    clustered_static_scan_sampler,
    gilbert_elliott_clustered,
)
from repro_torch.channel.markov import (
    GEParams,
    MarkovChannel,
    ge_scan_sampler,
    gilbert_elliott,
    sample_ge_rounds,
    sample_ge_rounds_host,
)
from repro_torch.channel.estimator import LinkEstimator
from repro_torch.channel.mobility import MobilityChannel
from repro_torch.channel.schedule import AdaptiveConfig, AdaptiveWeightSchedule

__all__ = [
    "ChannelProcess",
    "BlockBufferedChannel",
    "StaticChannel",
    "MarkovChannel",
    "MobilityChannel",
    "ClusteredStaticChannel",
    "ClusteredMarkovChannel",
    "ClusteredGEParams",
    "gilbert_elliott_clustered",
    "clustered_static_scan_sampler",
    "clustered_ge_scan_sampler",
    "GEParams",
    "gilbert_elliott",
    "ge_scan_sampler",
    "sample_ge_rounds",
    "sample_ge_rounds_host",
    "pair_lane_table",
    "stacked_trace",
    "static_scan_sampler",
    "LinkEstimator",
    "AdaptiveConfig",
    "AdaptiveWeightSchedule",
]

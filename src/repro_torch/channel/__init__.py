"""Connectivity processes: the paper's i.i.d. channel and the
Gilbert–Elliott bursty-blockage chains, dense and in clustered block
form."""

from repro_torch.channel.base import BlockBufferedChannel, StaticChannel, pair_lane_table
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

__all__ = [
    "BlockBufferedChannel",
    "StaticChannel",
    "pair_lane_table",
    "ClusteredGEParams",
    "ClusteredMarkovChannel",
    "ClusteredStaticChannel",
    "gilbert_elliott_clustered",
    "GEParams",
    "MarkovChannel",
    "gilbert_elliott",
    "sample_ge_rounds_host",
]

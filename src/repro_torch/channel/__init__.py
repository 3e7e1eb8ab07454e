"""Connectivity processes: the paper's i.i.d. channel and the
Gilbert–Elliott bursty-blockage chains."""

from repro_torch.channel.base import BlockBufferedChannel, StaticChannel
from repro_torch.channel.markov import (
    GEParams,
    MarkovChannel,
    gilbert_elliott,
    sample_ge_rounds_host,
)

__all__ = [
    "BlockBufferedChannel",
    "StaticChannel",
    "GEParams",
    "MarkovChannel",
    "gilbert_elliott",
    "sample_ge_rounds_host",
]

"""Scenario presets for the channel subsystem (the reference's
``repro.configs.channels``).

Each preset names a reproducible channel dynamic; :func:`make_channel`
instantiates it for a :class:`LinkModel` (``static`` / ``markov*``: the
model supplies the per-round marginals the channel keeps) or a client
count (``mobility*``: the geometry is the model, and it drifts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.channel import MarkovChannel, MobilityChannel, StaticChannel, gilbert_elliott
from repro_torch.core.connectivity import LinkModel

__all__ = ["ChannelPreset", "CHANNEL_PRESETS", "make_channel"]


@dataclasses.dataclass(frozen=True)
class ChannelPreset:
    kind: str  # static | markov | mobility
    # markov: gate memory (lag-1 autocorrelation); 0 = i.i.d. paper model
    memory: float = 0.9
    occupancy: Optional[float] = None
    block: int = 256  # rounds generated per block
    # mobility: geometry refresh cadence / client speed / roam half-width
    epoch: int = 20
    speed: float = 4.0
    area: float = 300.0
    d2d_mode: str = "intermittent"


CHANNEL_PRESETS = {
    # the paper's i.i.d. channel
    "static": ChannelPreset(kind="static"),
    # GE chains fitted to the model's marginals, i.i.d. gates — sanity
    # preset: distribution-identical to "static"
    "markov_iid": ChannelPreset(kind="markov", memory=0.0),
    # mmWave-style bursty blockage: ~10-round expected blockage bursts
    "markov": ChannelPreset(kind="markov", memory=0.9),
    # heavy blockage: ~30-round bursts, same marginals
    "markov_heavy": ChannelPreset(kind="markov", memory=0.97),
    # pedestrian-speed waypoint mobility, geometry refresh every 20 rounds
    "mobility": ChannelPreset(kind="mobility", epoch=20, speed=4.0),
    # vehicular-speed drift: topology turnover within ~a re-opt window
    "mobility_fast": ChannelPreset(kind="mobility", epoch=10, speed=15.0),
}


def make_channel(preset: "str | ChannelPreset", model: Optional[LinkModel] = None, *,
                 n: Optional[int] = None, seed: int = 0):
    """Instantiate a preset.

    ``static`` / ``markov*`` need ``model`` (the marginals to keep);
    ``mobility*`` needs ``n`` (or takes it from ``model``).
    """
    if isinstance(preset, str):
        try:
            preset = CHANNEL_PRESETS[preset]
        except KeyError:
            raise KeyError(
                f"unknown channel preset {preset!r}; have {sorted(CHANNEL_PRESETS)}"
            ) from None
    if preset.kind == "mobility":
        if n is None:
            if model is None:
                raise ValueError("mobility channel needs n (or a model for its n)")
            n = model.n
        return MobilityChannel(n, area=preset.area, speed=preset.speed, epoch=preset.epoch,
                               seed=seed, d2d_mode=preset.d2d_mode)
    if preset.kind not in ("static", "markov"):
        raise ValueError(f"unknown channel kind {preset.kind!r}")
    if model is None:
        raise ValueError(f"{preset.kind} channel needs a LinkModel")
    if preset.kind == "static":
        return StaticChannel(model, seed=seed)
    params = gilbert_elliott(model, memory=preset.memory, occupancy=preset.occupancy)
    return MarkovChannel(params, seed=seed, block=preset.block)

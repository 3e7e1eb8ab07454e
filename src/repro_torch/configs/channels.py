"""Scenario presets for the channel subsystem (the reference's
``repro.configs.channels``).

Each preset names a reproducible channel dynamic; :func:`make_channel`
instantiates it for a :class:`LinkModel`, whose per-round marginals the
channel keeps.  ``static`` and the ``markov*`` presets are ported; the
``mobility*`` presets (drifting geometry) raise ``NotImplementedError``
naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.channel import MarkovChannel, StaticChannel, gilbert_elliott
from repro_torch.core.connectivity import LinkModel

__all__ = ["ChannelPreset", "CHANNEL_PRESETS", "make_channel"]


@dataclasses.dataclass(frozen=True)
class ChannelPreset:
    kind: str  # static | markov | mobility
    # markov: gate memory (lag-1 autocorrelation); 0 = i.i.d. paper model
    memory: float = 0.9
    occupancy: Optional[float] = None
    block: int = 256  # rounds generated per block


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
    # the reference's drifting-geometry presets (pedestrian and vehicular
    # waypoint mobility), not ported yet
    "mobility": ChannelPreset(kind="mobility"),
    "mobility_fast": ChannelPreset(kind="mobility"),
}


def make_channel(preset: "str | ChannelPreset", model: Optional[LinkModel] = None, *,
                 seed: int = 0):
    """Instantiate a preset for ``model``, whose marginals the channel keeps."""
    if isinstance(preset, str):
        try:
            preset = CHANNEL_PRESETS[preset]
        except KeyError:
            raise KeyError(
                f"unknown channel preset {preset!r}; have {sorted(CHANNEL_PRESETS)}"
            ) from None
    if preset.kind == "mobility":
        raise NotImplementedError("mobility channels are not ported to repro_torch yet: "
                                  "ROADMAP.md queue 1, item 9 (channels: mobility)")
    if preset.kind not in ("static", "markov"):
        raise ValueError(f"unknown channel kind {preset.kind!r}")
    if model is None:
        raise ValueError(f"{preset.kind} channel needs a LinkModel")
    if preset.kind == "static":
        return StaticChannel(model, seed=seed)
    params = gilbert_elliott(model, memory=preset.memory, occupancy=preset.occupancy)
    return MarkovChannel(params, seed=seed, block=preset.block)

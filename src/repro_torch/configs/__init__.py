"""Configurations: the paper's FL experiment setup (``colrel_paper``,
``channels``) and the model zoo's architectures (``base`` and one module
per ported arch)."""

from .base import ARCH_IDS, CLI_ALIASES, INPUT_SHAPES, InputShape, get_arch, supported_shapes
from .channels import CHANNEL_PRESETS, ChannelPreset, make_channel

__all__ = [
    "ARCH_IDS",
    "CLI_ALIASES",
    "INPUT_SHAPES",
    "InputShape",
    "get_arch",
    "supported_shapes",
    "CHANNEL_PRESETS",
    "ChannelPreset",
    "make_channel",
]

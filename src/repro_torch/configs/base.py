"""Config registry of the model zoo: one module per architecture.

The counterpart of ``repro.configs.base``: the same arch ids, CLI aliases
and input shapes.  Each ported arch module defines ``full()`` (the
assigned configuration), ``smoke()`` (a reduced same-family variant) and
``SHAPES``.  All ten architectures are ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

__all__ = ["ARCH_IDS", "CLI_ALIASES", "InputShape", "INPUT_SHAPES", "get_arch",
           "supported_shapes"]

ARCH_IDS: List[str] = [
    "seamless_m4t_large_v2",
    "dbrx_132b",
    "olmo_1b",
    "qwen3_0_6b",
    "granite_moe_3b_a800m",
    "jamba_1_5_large_398b",
    "deepseek_coder_33b",
    "rwkv6_1_6b",
    "internvl2_2b",
    "gemma3_1b",
]

# canonical CLI ids (--arch <id>) -> module name
CLI_ALIASES: Dict[str, str] = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "dbrx-132b": "dbrx_132b",
    "olmo-1b": "olmo_1b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "internvl2-2b": "internvl2_2b",
    "gemma3-1b": "gemma3_1b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_arch(arch_id: str):
    """Resolve an arch id (CLI or module form) to its config module."""
    mod = CLI_ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(CLI_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def supported_shapes(arch_id: str) -> List[str]:
    return list(get_arch(arch_id).SHAPES)

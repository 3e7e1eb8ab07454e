"""Feed-forward blocks: SwiGLU (llama-family), GELU (enc-dec), ReLU^2 (rwkv).

The counterpart of ``repro.models.mlp``.  GELU is ``jax.nn.gelu``'s
default, the tanh approximation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.layout import merge_ready
from repro_torch.models.common import ModelConfig, Params, dense_init

__all__ = ["init_mlp", "apply_mlp"]


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wg": dense_init(gen, (d, f), cfg.tdtype),
                "wu": dense_init(gen, (d, f), cfg.tdtype),
                "wd": dense_init(gen, (f, d), cfg.tdtype)}
    return {"wu": dense_init(gen, (d, f), cfg.tdtype),
            "wd": dense_init(gen, (f, d), cfg.tdtype)}


def apply_mlp(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = merge_ready(x)
    if cfg.mlp == "swiglu":
        g = F.silu(x @ params["wg"])
        return (g * (x @ params["wu"])) @ params["wd"]
    h = x @ params["wu"]
    if cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp == "relu_sq":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp {cfg.mlp}")
    return h @ params["wd"]

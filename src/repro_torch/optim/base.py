"""Functional optimizers over trees of tensors: an optimizer is an
``(init, update)`` pair, optax-style.

``update(grads, state, params) -> (updates, state)`` returns *additive*
updates; :func:`apply_updates` adds them.  The round keeps these
functional instead of using ``torch.optim`` because the PS feeds the
negated round delta to its optimizer as a pseudo-gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree

Params = Any

__all__ = ["Optimizer", "apply_updates", "tree_zeros_like", "global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple]


def apply_updates(params: Params, updates: Params) -> Params:
    """``params + updates``, added in f32 and cast back to each param's dtype."""
    return tree.map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def tree_zeros_like(params: Params, dtype=torch.float32) -> Params:
    return tree.map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params)


def global_norm(t: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.leaves(t)))

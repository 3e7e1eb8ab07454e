"""AdamW for the transformer training examples."""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.optim.base import Optimizer, tree_zeros_like
from repro_torch.optim.sgd import Schedule, lr_at, step0

__all__ = ["adamw"]


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Bias-corrected Adam with decoupled weight decay; moments in f32."""

    def init(params):
        return {"step": step0(params), "m": tree_zeros_like(params),
                "v": tree_zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr_at(lr, step)
        m = tree.map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads, state["m"])
        v = tree.map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()), grads, state["v"])
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def u(m, v, p):
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return -eta * upd

        return tree.map(u, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)

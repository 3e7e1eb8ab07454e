"""SGD and SGD-with-momentum (the paper's client and server optimizers).

The paper uses plain SGD at the clients (lr 0.05, l2 1e-4) and momentum
(beta = 0.9) applied at the PS on the aggregated round delta.  Updates
are computed in f32 whatever the parameter dtype.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.optim.base import Optimizer, tree_zeros_like

__all__ = ["sgd", "sgd_momentum"]


def sgd(lr: float, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        def u(g, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            return -lr * g

        return tree.map(u, grads, params), {"step": state["step"] + 1}

    return Optimizer(init, update)


def sgd_momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": 0, "m": tree_zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params):
        m = tree.map(lambda g, m: beta * m + g.float(), grads, state["m"])
        return tree.map(lambda m: -lr * m, m), {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)

"""SGD and SGD-with-momentum (the paper's client and server optimizers).

The paper uses plain SGD at the clients (lr 0.05, l2 1e-4) and momentum
(beta = 0.9) applied at the PS on the aggregated round delta.  Updates
are computed in f32 whatever the parameter dtype.  The step counter is a
0-d int32 tensor on the params' device, as the reference's, so a CUDA graph
that captures a round advances it on every replay.  The learning rate is
a float or a schedule (:mod:`repro_torch.optim.schedule`): a callable of
the step tensor, evaluated on the device.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch import tree
from repro_torch.optim.base import Optimizer, tree_zeros_like

__all__ = ["Schedule", "sgd", "sgd_momentum"]

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def lr_at(schedule: Schedule, step: torch.Tensor):
    """The learning rate at ``step``: the float itself, or the schedule's
    0-d f32 tensor."""
    return schedule(step) if callable(schedule) else schedule


def step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device)


def _decayed(g: torch.Tensor, p: torch.Tensor, weight_decay: float) -> torch.Tensor:
    g = g.float()
    return g + weight_decay * p.float() if weight_decay else g


def sgd(lr: Schedule, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        eta = lr_at(lr, state["step"])
        upd = tree.map(lambda g, p: -eta * _decayed(g, p, weight_decay), grads, params)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)


def sgd_momentum(lr: Schedule, beta: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": step0(params), "m": tree_zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params):
        eta = lr_at(lr, state["step"])
        m = tree.map(lambda g, m, p: beta * m + _decayed(g, p, weight_decay),
                     grads, state["m"], params)
        if nesterov:
            upd = tree.map(lambda g, m: -eta * (g.float() + beta * m), grads, m)
        else:
            upd = tree.map(lambda m: -eta * m, m)
        return upd, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)

"""Learning-rate schedules, including the paper's Theorem 1 inverse decay
``eta_r = (4/mu) / (r*T + 1)`` used by the strongly-convex validation.

A schedule maps the optimizer's 0-d int32 step tensor to a 0-d f32 tensor
on the step's device, by device arithmetic alone (no host read of the
step), so a round captured as a CUDA graph follows the schedule on every
replay.
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "inverse_round_decay", "cosine_decay", "warmup_cosine"]


def _f32(step: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=step.device)


def constant(lr: float):
    return lambda step: _f32(step, lr)


def inverse_round_decay(c: float, period: int, offset: float = 1.0):
    """eta_r = c / (r * period + offset)  — Theorem 1's schedule."""
    return lambda step: _f32(step, c) / (step.float() * period + offset)


def _cosine(t: torch.Tensor, final_frac: float) -> torch.Tensor:
    return final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.float() / steps, max=1.0)
        return _f32(step, lr) * _cosine(t, final_frac)

    return f


def warmup_cosine(lr: float, warmup: int, steps: int, final_frac: float = 0.0):
    def f(step):
        s = step.float()
        warm = s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(steps - warmup, 1), 0.0, 1.0)
        return _f32(step, lr) * torch.where(s < warmup, warm, _cosine(t, final_frac))

    return f

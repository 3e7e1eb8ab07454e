"""Model helpers shared by the port's models."""

from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy"]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE; logits (..., V), labels (...) integer.  f32 inside:
    logsumexp minus the gold logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return logz - gold

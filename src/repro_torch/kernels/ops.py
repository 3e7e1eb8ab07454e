"""Public entry points of the aggregation kernels, dispatched on the
tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from one to the other.

Segment streaming: at large d the ``(n, d)`` stack itself is the memory
bottleneck, so :func:`collapsed_weight_row` computes the weight row once
per round and each per-leaf ``(n, d_i)`` segment streams through
:func:`row_stream`.  Every output column is a function of its own input
column only, and both paths run the same arithmetic, so per-segment
outputs equal the matching columns of :func:`fused_aggregate` bitwise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels.fused_aggregate import collapsed_weight_row, mixing_mask

__all__ = ["mixing_mask", "collapsed_weight_row", "fused_aggregate", "row_stream"]


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def fused_aggregate(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                    updates: torch.Tensor, *, block_d: int = 2048) -> torch.Tensor:
    """One-pass ColRel PS delta ``(1/n) tau_up @ ((A * tau_dd^T) @ updates)``:
    the (n, d) stack is read once; the output is the (d,) f32 delta."""
    if _on_cpu(updates):
        return fa.fused_aggregate_plain(A, tau_up, tau_dd, updates)
    return fa.fused_aggregate_cuda(A, tau_up, tau_dd, updates, block_d=block_d)


def row_stream(w: torch.Tensor, segment: torch.Tensor, *,
               block_d: int = 2048) -> torch.Tensor:
    """One segment's PS-delta columns ``w @ segment`` ((n,) x (n, d_i) ->
    (d_i,) f32); takes f32, bf16 and int8 segments."""
    if _on_cpu(segment):
        return fa.row_stream_plain(w, segment)
    return fa.row_stream_cuda(w, segment, block_d=block_d)

"""Public entry points of the aggregation kernels, dispatched on the
tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from one to the other.

Segment streaming: at large d the ``(n, d)`` stack itself is the memory
bottleneck, so the per-round operand — :func:`collapsed_weight_row`, its
scale-folded form :func:`fold_dequant_scales`, or the realized mask
:func:`mixing_mask` — is computed once per round and each per-leaf
``(n, d_i)`` segment streams through :func:`row_stream`,
:func:`dequant_row_stream` or :func:`memory_stream`.  Every output column
is a function of its own input column only, and both paths run the same
arithmetic, so per-segment outputs equal the matching columns of the
monolithic pass bitwise.

The memory functions update the replay buffer they are given in place
(see :mod:`repro_torch.kernels.fused_memory`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels import fused_dequant as fdq
from repro_torch.kernels import fused_memory as fm
from repro_torch.kernels.fused_aggregate import collapsed_weight_row, mixing_mask
from repro_torch.kernels.fused_dequant import fold_dequant_scales

__all__ = [
    "mixing_mask",
    "collapsed_weight_row",
    "fold_dequant_scales",
    "fused_aggregate",
    "row_stream",
    "fused_memory_update",
    "memory_stream",
    "fused_dequant_aggregate",
    "dequant_row_stream",
]


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


def fused_memory_update(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                        updates: torch.Tensor, buffer: torch.Tensor, *,
                        block_d: int = 2048):
    """One-pass memory round: ``tilde = (A * tau_dd^T) @ updates``,
    ``contrib = tau_up * tilde + (1 - tau_up) * buffer``; returns ``(delta
    (d,) f32, buffer)`` with ``buffer`` overwritten by ``contrib``."""
    if _on_cpu(updates):
        return fm.fused_memory_update_plain(A, tau_up, tau_dd, updates, buffer)
    return fm.fused_memory_update_cuda(A, tau_up, tau_dd, updates, buffer, block_d=block_d)


def memory_stream(mix: torch.Tensor, tau_up: torch.Tensor, segment: torch.Tensor,
                  buf_seg: torch.Tensor, *, block_d: int = 2048):
    """One segment of the memory round against the realized mask: returns
    ``(delta_seg (d_i,) f32, buf_seg)`` with the buffer's columns (a
    strided view of the carried buffer) overwritten by ``contrib``."""
    if _on_cpu(segment):
        return fm.memory_stream_plain(mix, tau_up, segment, buf_seg)
    return fm.memory_stream_cuda(mix, tau_up, segment, buf_seg, block_d=block_d)


def fused_dequant_aggregate(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                            q: torch.Tensor, scale: torch.Tensor, *,
                            block_d: int = 2048) -> torch.Tensor:
    """One-pass quantized ColRel PS delta over the int8 wire stack ``q``
    with per-row ``scale``: ``((1/n) tau_up @ (A * tau_dd^T) * scale^T) @
    q``; the f32 stack never exists."""
    if _on_cpu(q):
        return fdq.fused_dequant_aggregate_plain(A, tau_up, tau_dd, q, scale)
    return fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, q, scale, block_d=block_d)


def dequant_row_stream(ws: torch.Tensor, q_segment: torch.Tensor, *,
                       block_d: int = 2048) -> torch.Tensor:
    """One int8 segment against the scale-folded weight row ``ws``:
    :func:`row_stream` on the int8 columns as they are (the counterpart of
    ``repro.kernels.fused_dequant.dequant_row_stream_pallas``)."""
    if q_segment.dtype != torch.int8:
        raise TypeError(f"dequant_row_stream takes an int8 segment, got {q_segment.dtype}")
    return row_stream(ws, q_segment, block_d=block_d)

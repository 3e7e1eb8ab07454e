"""Public entry points of the aggregation kernels, dispatched on the
tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from one to the other.

Segment streaming: at large d the ``(n, d)`` stack itself is the memory
bottleneck, so the per-round operand — :func:`collapsed_weight_row`, its
scale-folded form :func:`fold_dequant_scales`, or the realized mask
:func:`mixing_mask` — is computed once per round and the per-leaf
``(n, d_i)`` segments stream through :func:`row_stream_segments` (f32,
bf16 or int8) or :func:`memory_stream_segments`, one launch over the
round's segment list, or one at a time through :func:`row_stream`,
:func:`dequant_row_stream` or :func:`memory_stream`.  Every output column
is a function of its own input column only, and all paths run the same
arithmetic, so grouped, per-segment and monolithic outputs agree
bitwise.

The memory functions update the replay buffer they are given in place
(see :mod:`repro_torch.kernels.fused_memory`).

The ``block_*`` functions are the clustered twins: the relay weights and
the D2D realizations come as ``(C, m, m)`` blocks, the per-round operand
is :func:`block_collapsed_weight_row`, and the dense (n, n) mask never
exists (see :mod:`repro_torch.kernels.relay_block`).

:func:`flash_attention` is the model zoo's causal self-attention over
``(B, T, H, D)`` (see :mod:`repro_torch.kernels.flash_attention`), and
:func:`ssd_scan` Mamba2's chunked SSD recurrence over ``(BH, T, D)`` (see
:mod:`repro_torch.kernels.ssd_scan`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels import fused_dequant as fdq
from repro_torch.kernels import fused_memory as fm
from repro_torch.kernels import relay_block as rb
from repro_torch.kernels import relay_mix as rm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.fused_aggregate import collapsed_weight_row, mixing_mask
from repro_torch.kernels.fused_dequant import fold_dequant_scales
from repro_torch.kernels.relay_block import block_collapsed_weight_row

__all__ = [
    "mixing_mask",
    "collapsed_weight_row",
    "fold_dequant_scales",
    "fused_aggregate",
    "row_stream",
    "row_stream_segments",
    "fused_memory_update",
    "memory_stream",
    "memory_stream_segments",
    "fused_dequant_aggregate",
    "dequant_row_stream",
    "relay_mix",
    "block_relay_mix",
    "block_collapsed_weight_row",
    "block_fused_aggregate",
    "block_row_stream",
    "flash_attention",
    "ssd_scan",
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


def row_stream_segments(w: torch.Tensor, segments, *, block_d: int = 2048) -> torch.Tensor:
    """A round's PS-delta columns ``w @ segment_i`` over its list of (n, d_i)
    segments (one dtype: f32, bf16 or int8), one launch on the card:
    (sum d_i,) f32, segment after segment."""
    if _on_cpu(segments[0]):
        return fa.row_stream_segments_plain(w, segments)
    return fa.row_stream_segments_cuda(w, segments, block_d=block_d)


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


def memory_stream_segments(mix: torch.Tensor, tau_up: torch.Tensor, segments,
                           buf: torch.Tensor, *, block_d: int = 2048):
    """A round's memory update over its list of (n, d_i) segments, which
    tile the carried (n, d) buffer's columns in order, one launch on the
    card: returns ``(delta (d,) f32, buf)`` with ``buf`` overwritten by
    ``contrib``."""
    if _on_cpu(segments[0]):
        return fm.memory_stream_segments_plain(mix, tau_up, segments, buf)
    return fm.memory_stream_segments_cuda(mix, tau_up, segments, buf, block_d=block_d)


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


def relay_mix(mixing: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """ColRel consensus ``mixing @ updates`` for a given (n, n) realized
    mask: (n, d) in the stack's dtype, f32 accumulation."""
    if _on_cpu(updates):
        return rm.relay_mix_plain(mixing, updates)
    return rm.relay_mix_cuda(mixing, updates)


def block_relay_mix(Ab: torch.Tensor, tau_b: torch.Tensor,
                    updates: torch.Tensor) -> torch.Tensor:
    """Blocked consensus ``Dx~_c = (A_c * tau_c^T) @ Dx_c`` over (C, m, m)
    cluster blocks: (n, d) in the stack's dtype."""
    if _on_cpu(updates):
        return rb.block_relay_mix_plain(Ab, tau_b, updates)
    return rb.block_relay_mix_cuda(Ab, tau_b, updates)


def block_fused_aggregate(Ab: torch.Tensor, tau_up: torch.Tensor, tau_b: torch.Tensor,
                          updates: torch.Tensor, *, block_d: int = 2048) -> torch.Tensor:
    """One-pass blocked ColRel PS delta ``(1/n) sum_c tau_c @ ((A_c *
    tau_c^T) @ Dx_c)`` over (C, m, m) cluster blocks: the (n, d) stack is
    read once; the output is the (d,) f32 delta."""
    if _on_cpu(updates):
        return rb.block_fused_aggregate_plain(Ab, tau_up, tau_b, updates)
    return rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, updates, block_d=block_d)


def block_row_stream(w: torch.Tensor, segment: torch.Tensor, *,
                     block_d: int = 2048) -> torch.Tensor:
    """One segment's blocked PS-delta columns ``sum_c w_c @ segment_c``
    ((C, m) x (n, d_i) -> (d_i,) f32)."""
    if _on_cpu(segment):
        return rb.block_row_stream_plain(w, segment)
    return rb.block_row_stream_cuda(w, segment, block_d=block_d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, T, KV, D) -> (B, T, H, D) causal attention.

    Grouped kv heads serve ``H // KV`` query heads each (as ``jnp.repeat``
    on the head axis).  On the card the kernel reads them, and q, k, v as
    the strided views they are, in place; the plain version on the CPU
    broadcasts and works heads-first.  ``block_q``/``block_kv`` keep the
    reference's rule that T is a whole number of ``min(block, T)`` blocks;
    the kernel's own tiles are fixed and it would take any T."""
    if not causal:
        raise ValueError("flash_attention: only causal self-attention is kernelized")
    B, T, H, D = q.shape
    KV = k.shape[2]
    if k.shape[1] != T or v.shape[1] != T:
        raise ValueError(f"flash_attention: self-attention takes S == T, got q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    if H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} kv heads")
    bq, bkv = min(block_q, T), min(block_kv, T)
    if T % bq or T % bkv:
        raise ValueError(f"flash_attention: T={T} is not a whole number of blocks "
                         f"(block_q={bq}, block_kv={bkv}), as the reference kernel requires")
    if not _on_cpu(q):
        return fl.flash_attention_cuda(q, k, v)
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)

    def heads_first(x):
        return x.transpose(1, 2).reshape(B * H, T, D).contiguous()

    out = fl.flash_attention_plain(heads_first(q), heads_first(k), heads_first(v))
    return out.reshape(B, H, T, D).transpose(1, 2)


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor, *,
             chunk: int = 64) -> torch.Tensor:
    """Chunked SSD recurrence from a zero state (Mamba2's hot loop): q, k
    (BH, T, Dk), v (BH, T, Dv), log_decay (BH, T) non-positive -> y (BH, T,
    Dv) in q's dtype.  The leading BH may also come split as (B, H), as
    strided views (see :mod:`repro_torch.kernels.ssd_scan`).  T must be a
    whole number of chunks, as the reference kernel requires: both
    versions raise otherwise."""
    if _on_cpu(q):
        return ssd.ssd_scan_plain(q, k, v, log_decay.float(), chunk=chunk)
    return ssd.ssd_scan_cuda(q, k, v, log_decay.float(), chunk=chunk)

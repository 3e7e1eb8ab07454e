"""The memory strategy's select-accumulate-update as hand-written Hopper
kernels, and their plain PyTorch versions.

Replaces ``repro/kernels/fused_memory.py``:

* :func:`fused_memory_update_cuda` for ``fused_memory_update_pallas`` —
  one pass over the round's ``(n, d)`` update stack X and the ``(n, d)``
  replay buffer B::

      tilde   = (A * tau_dd^T) @ X
      contrib = tau_up * tilde + (1 - tau_up) * B
      delta   = (1/n) sum_i contrib_i
      B      <- contrib

  with ``tilde`` kept out of device memory.
* :func:`memory_stream_cuda` for ``memory_stream_pallas`` — the same for
  one leaf's ``(n, d_i)`` segment against the realized mask
  ``A * tau_dd^T`` that the caller computes once a round; the buffer
  segment is a column slice of the carried ``(n, d)`` buffer (row stride
  d), so no copy of it is made.
* :func:`memory_stream_segments_cuda` — the same over a round's whole
  segment list in one launch: the segments tile the carried buffer's
  columns in order, and one ``(d,)`` delta comes back.  The segmented
  memory path makes one launch a round where it made one per leaf.

**The buffer is updated in place.**  Every function here writes
``contrib`` into the buffer it was given and returns ``(delta, buffer)``
with that same tensor: where the reference donates the buffer to XLA,
the port overwrites it.  A caller that needs the old buffer clones it
first.

The kernels live in ``csrc/fused_memory.cu`` (design and bound in its
header).  The plain versions run the kernels' arithmetic in the kernels'
order — tilde summed over j in order, each product and sum rounded on its
own, delta summed over i in order and scaled by ``1/n`` — so kernel and
plain version agree to the bit, and a per-segment pass gives exactly the
columns of the monolithic one; the grouped plain version is the
per-segment loop.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_aggregate import (
    _check_block,
    _check_segments,
    _operand,
    _raise_on,
    _same_stack,
    _table,
    mixing_mask,
)

__all__ = [
    "fused_memory_update_plain",
    "memory_stream_plain",
    "memory_stream_segments_plain",
    "fused_memory_update_cuda",
    "memory_stream_cuda",
    "memory_stream_segments_cuda",
]

# element type codes of csrc/fused_memory.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels keep the (n, n) mask and two (n,) rows in shared memory:
# (n*n + 2n) floats within the 48 KB a launch gets without opting in
_MAX_N = 109


def _memory_plain(mix: torch.Tensor, tau_up: torch.Tensor, x: torch.Tensor,
                  buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x.shape
    tilde = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for j in range(n):
        tilde += mix[:, j, None] * x[j].float()
    t = tau_up.float()[:, None]
    contrib = t * tilde + (1.0 - t) * buf
    acc = torch.zeros(d, dtype=torch.float32, device=x.device)
    for i in range(n):
        acc += contrib[i]
    buf.copy_(contrib)
    return acc * (1.0 / n), buf


def fused_memory_update_plain(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                              updates: torch.Tensor, buffer: torch.Tensor):
    """Plain version of :func:`fused_memory_update_cuda`: ``(delta (d,) f32,
    buffer)`` with ``buffer`` overwritten by ``contrib``."""
    return _memory_plain(mixing_mask(A, tau_dd), tau_up, updates, buffer)


def memory_stream_plain(mix: torch.Tensor, tau_up: torch.Tensor, segment: torch.Tensor,
                        buf_seg: torch.Tensor):
    """Plain version of :func:`memory_stream_cuda`: ``(delta_seg (d_i,) f32,
    buf_seg)`` with ``buf_seg`` overwritten by the segment's ``contrib``."""
    return _memory_plain(mix.float(), tau_up, segment, buf_seg)


def _check_fit(segments, buf: torch.Tensor, what: str) -> None:
    d = sum(s.shape[1] for s in segments)
    if buf.ndim != 2 or tuple(buf.shape) != (segments[0].shape[0], d):
        raise ValueError(f"{what}: the segments tile an (n, d) = ({segments[0].shape[0]}, {d}) "
                         f"buffer, got one of shape {tuple(buf.shape)}")


def memory_stream_segments_plain(mix: torch.Tensor, tau_up: torch.Tensor,
                                 segments: Sequence[torch.Tensor], buf: torch.Tensor):
    """Plain version of :func:`memory_stream_segments_cuda`: the per-segment
    passes over the buffer's columns in order; ``(delta (d,) f32, buf)``."""
    _check_fit(segments, buf, "memory_stream_segments")
    deltas, off = [], 0
    for seg in segments:
        d = seg.shape[1]
        deltas.append(memory_stream_plain(mix, tau_up, seg, buf[:, off:off + d])[0])
        off += d
    return torch.cat(deltas), buf


# -- the CUDA wrappers -------------------------------------------------------


def _check_rows(t: torch.Tensor, shape, dtypes, what: str) -> None:
    """A CUDA (n, d) operand whose rows are contiguous (any row stride)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes a CUDA tensor, got one on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {tuple(dtypes)}")
    if shape is None:
        if t.ndim != 2 or t.shape[1] < 1 or not 1 <= t.shape[0] <= _MAX_N:
            raise ValueError(f"{what}: needs an (n, d) stack with 1 <= n <= {_MAX_N} "
                             f"and d >= 1, got {tuple(t.shape)}")
    elif tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{what}: rows must be contiguous, got strides {t.stride()}")


def _check_operands(x: torch.Tensor, buf: torch.Tensor, block_d: int, what: str):
    _check_rows(x, None, tuple(_DTYPE_CODES), what)
    _check_rows(buf, x.shape, (torch.float32,), f"{what} buffer")
    _check_block(block_d)
    if buf.device != x.device:
        raise ValueError(f"{what}: buffer on {buf.device}, the stack is on {x.device}")
    return x.shape[0], x.shape[1], x.device


def fused_memory_update_cuda(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                             updates: torch.Tensor, buffer: torch.Tensor, *,
                             block_d: int = 2048):
    """One-pass memory round over an (n, d) f32 or bf16 CUDA stack and the
    (n, d) f32 replay buffer: returns ``(delta (d,) f32, buffer)`` with the
    buffer overwritten by ``contrib``.  Each CUDA block covers ``block_d``
    columns."""
    n, d, dev = _check_operands(updates, buffer, block_d, "fused_memory_update")
    a = _operand(A, (n, n), dev, "A")
    tu = _operand(tau_up, (n,), dev, "tau_up")
    td = _operand(tau_dd, (n, n), dev, "tau_dd")
    delta = torch.empty(d, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_fused_memory_update(
            a.data_ptr(), tu.data_ptr(), td.data_ptr(), updates.data_ptr(), updates.stride(0),
            buffer.data_ptr(), buffer.stride(0), delta.data_ptr(), n, d, block_d,
            _DTYPE_CODES[updates.dtype], 1.0 / n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "fused_memory_update")
    fused_memory_update_cuda.launches += 1
    return delta, buffer


fused_memory_update_cuda.launches = 0


def _launch_stream(mix, tau_up, segments, buf, block_d: int, what: str) -> torch.Tensor:
    _check_segments(segments, what)
    for seg in segments:
        _same_stack(seg, segments[0], what)
    _check_fit(segments, buf, what)
    for seg in segments:
        _check_operands(seg, buf[:, :seg.shape[1]], block_d, what)
    n, dev = buf.shape[0], buf.device
    m = _operand(mix, (n, n), dev, "mix")
    tu = _operand(tau_up, (n,), dev, "tau_up")
    delta = torch.empty(buf.shape[1], dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_memory_stream(
            m.data_ptr(), tu.data_ptr(),
            _table((s.data_ptr(), s.stride(0), s.shape[1]) for s in segments), len(segments),
            buf.data_ptr(), buf.stride(0), delta.data_ptr(), n, block_d,
            _DTYPE_CODES[segments[0].dtype], 1.0 / n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, what)
    return delta


def memory_stream_cuda(mix: torch.Tensor, tau_up: torch.Tensor, segment: torch.Tensor,
                       buf_seg: torch.Tensor, *, block_d: int = 2048):
    """One segment of the memory round against the realized mask ``mix``
    (n, n): ``segment`` is the leaf's (n, d_i) f32 or bf16 update columns
    and ``buf_seg`` the matching (n, d_i) columns of the f32 replay buffer,
    any row stride (a column slice of the carried buffer).  Returns
    ``(delta_seg (d_i,) f32, buf_seg)`` with ``buf_seg`` overwritten by the
    segment's ``contrib``."""
    delta = _launch_stream(mix, tau_up, [segment], buf_seg, block_d, "memory_stream")
    memory_stream_cuda.launches += 1
    return delta, buf_seg


memory_stream_cuda.launches = 0


def memory_stream_segments_cuda(mix: torch.Tensor, tau_up: torch.Tensor,
                                segments: Sequence[torch.Tensor], buf: torch.Tensor, *,
                                block_d: int = 2048):
    """A round's memory update over its segment list in one launch: the
    (n, d_i) f32 or bf16 CUDA segments (one dtype, one n, rows contiguous)
    tile the columns of the (n, d) f32 replay buffer in order.  Returns
    ``(delta (d,) f32, buf)`` with ``buf`` overwritten by ``contrib``."""
    delta = _launch_stream(mix, tau_up, list(segments), buf, block_d, "memory_stream_segments")
    memory_stream_segments_cuda.launches += 1
    return delta, buf


memory_stream_segments_cuda.launches = 0

"""The ColRel PS aggregation as hand-written Hopper kernels, and their plain
PyTorch versions.

Replaces ``repro/kernels/fused_aggregate.py``:

* :func:`fused_aggregate_cuda` for ``fused_aggregate_pallas`` — the
  one-pass PS delta ``(1/n) tau_up @ ((A * tau_dd^T) @ X)``: the mask and
  the collapsed weight row are computed inside the kernel and the
  ``(n, d)`` stack crosses device memory once.
* :func:`row_stream_cuda` for ``row_stream_pallas`` — ``w @ segment`` for
  one ``(n, d_i)`` leaf segment with the weight row given, so the
  monolithic stack never has to exist.
* :func:`row_stream_segments_cuda` — the same kernel over a round's whole
  segment list in one launch, writing one ``(d,)`` row: the segmented
  colrel and quantized paths make one launch a round where they made one
  per leaf.  The segment list travels by value in the kernel's parameters
  (at most :data:`MAX_SEGMENTS` segments; the wrapper raises past it).

The kernels live in ``csrc/fused_aggregate.cu`` (design and bound in its
header).  Each wrapper checks its inputs, launches on the current stream
without synchronising, and counts its launches in ``launches``.  It takes
CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain versions below.

The plain versions run the kernels' arithmetic in the kernels' order —
weights collapsed over i in order, then rows accumulated in order, each
product and sum rounded on its own — so on any device they give the
kernels' result to the bit, and a per-segment pass gives exactly the
columns of the monolithic one; the grouped plain version is the
per-segment loop.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

__all__ = [
    "MAX_SEGMENTS",
    "mixing_mask",
    "collapsed_weight_row",
    "fused_aggregate_plain",
    "row_stream_plain",
    "row_stream_segments_plain",
    "fused_aggregate_cuda",
    "row_stream_cuda",
    "row_stream_segments_cuda",
]

# element type codes of csrc/fused_aggregate.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the fused kernels make the (n,) weight row in dynamic shared memory; 4096
# floats stay well inside the 48 KB a launch gets without opting in
_MAX_N = 4096
# the segment table a grouped launch carries in its kernel parameters
# (kMaxSegments of csrc/common.cuh)
MAX_SEGMENTS = 96


def mixing_mask(A: torch.Tensor, tau_dd: torch.Tensor) -> torch.Tensor:
    """Realized mixing mask ``A * tau_dd^T`` (n, n) f32."""
    return A.float() * tau_dd.float().T


def collapsed_weight_row(A: torch.Tensor, tau_up: torch.Tensor,
                         tau_dd: torch.Tensor) -> torch.Tensor:
    """The ColRel collapse ``(1/n) tau_up @ (A * tau_dd^T)`` as an (n,) f32
    row, summed over i in order exactly as the fused kernel does."""
    n = tau_up.shape[0]
    m = mixing_mask(A, tau_dd)
    t = tau_up.float()
    acc = torch.zeros(n, dtype=torch.float32, device=m.device)
    for i in range(n):
        acc = acc + t[i] * m[i]
    return acc * (1.0 / n)


def _weighted_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for j in range(x.shape[0]):
        acc += w[j] * x[j].float()
    return acc


def fused_aggregate_plain(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                          updates: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_aggregate_cuda`: (d,) f32."""
    return _weighted_rows(collapsed_weight_row(A, tau_up, tau_dd), updates)


def row_stream_plain(w: torch.Tensor, segment: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_stream_cuda`: (d_i,) f32."""
    return _weighted_rows(w.float(), segment)


def row_stream_segments_plain(w: torch.Tensor, segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of :func:`row_stream_segments_cuda`: the per-segment
    rows one after another, (sum d_i,) f32."""
    return torch.cat([row_stream_plain(w, s) for s in segments])


# -- the CUDA wrappers -------------------------------------------------------


def _check_stack(x: torch.Tensor, dtypes, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes a CUDA tensor, got one on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not in {tuple(dtypes)}")
    if x.ndim != 2 or x.shape[1] < 1 or not 1 <= x.shape[0] <= _MAX_N:
        raise ValueError(f"{what}: needs an (n, d) stack with 1 <= n <= {_MAX_N} "
                         f"and d >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the stack must be contiguous")


def _check_block(block_d: int) -> None:
    if block_d <= 0 or block_d % 16:
        raise ValueError(f"block_d must be a positive multiple of 16, got {block_d}")


def _operand(t: torch.Tensor, shape, device, what: str) -> torch.Tensor:
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, the stack is on {device}")
    return t.to(torch.float32).contiguous()


def _check_segments(segments, what: str) -> None:
    """A non-empty list that fits the kernel's segment table."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{what}: one launch takes 1 to {MAX_SEGMENTS} segments (the table "
                         f"in its kernel parameters), got {len(segments)}")


def _same_stack(seg: torch.Tensor, first: torch.Tensor, what: str) -> None:
    if seg.device != first.device or seg.dtype != first.dtype or seg.shape[0] != first.shape[0]:
        raise ValueError(f"{what}: every segment must share the first one's device, dtype and n "
                         f"({first.device}, {first.dtype}, n={first.shape[0]}); got "
                         f"{seg.device}, {seg.dtype}, n={seg.shape[0]}")


def _table(rows) -> ctypes.Array:
    """The segment table as the C launchers take it: int64 fields, row by row."""
    flat = [int(v) for row in rows for v in row]
    return (ctypes.c_int64 * len(flat))(*flat)


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.repro_error_string(err).decode()} ({err})")


def fused_aggregate_cuda(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                         updates: torch.Tensor, *, block_d: int = 2048) -> torch.Tensor:
    """One-pass ColRel PS delta ``(1/n) tau_up @ ((A * tau_dd^T) @ updates)``
    for an (n, d) f32 or bf16 CUDA stack; returns the (d,) f32 delta.
    Each CUDA block covers at most ``block_d`` columns (fewer where that
    keeps every block of the grid resident at once)."""
    _check_stack(updates, (torch.float32, torch.bfloat16), "fused_aggregate")
    _check_block(block_d)
    n, d = updates.shape
    dev = updates.device
    a = _operand(A, (n, n), dev, "A")
    tu = _operand(tau_up, (n,), dev, "tau_up")
    td = _operand(tau_dd, (n, n), dev, "tau_dd")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_fused_aggregate(
            a.data_ptr(), tu.data_ptr(), td.data_ptr(), updates.data_ptr(),
            out.data_ptr(), n, d, block_d, _DTYPE_CODES[updates.dtype], 1.0 / n,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "fused_aggregate")
    fused_aggregate_cuda.launches += 1
    return out


fused_aggregate_cuda.launches = 0


def _launch_row_stream(w: torch.Tensor, segments, block_d: int, what: str) -> torch.Tensor:
    _check_segments(segments, what)
    for seg in segments:
        _same_stack(seg, segments[0], what)
    for seg in segments:
        _check_stack(seg, tuple(_DTYPE_CODES), what)
    _check_block(block_d)
    n = segments[0].shape[0]
    dev = segments[0].device
    wf = _operand(w, (n,), dev, "w")
    out = torch.empty(sum(s.shape[1] for s in segments), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_row_stream(
            wf.data_ptr(), _table((s.data_ptr(), s.shape[1]) for s in segments), len(segments),
            out.data_ptr(), n, block_d, _DTYPE_CODES[segments[0].dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, what)
    return out


def row_stream_cuda(w: torch.Tensor, segment: torch.Tensor, *,
                    block_d: int = 2048) -> torch.Tensor:
    """One segment's PS-delta columns ``w @ segment`` for an (n, d_i) f32,
    bf16 or int8 CUDA segment; returns (d_i,) f32."""
    out = _launch_row_stream(w, [segment], block_d, "row_stream")
    row_stream_cuda.launches += 1
    return out


row_stream_cuda.launches = 0


def row_stream_segments_cuda(w: torch.Tensor, segments: Sequence[torch.Tensor], *,
                             block_d: int = 2048) -> torch.Tensor:
    """A round's segments ``w @ segment_i`` in one launch: every segment an
    (n, d_i) contiguous CUDA stack of one dtype (f32, bf16 or int8) and one
    n; returns the (sum d_i,) f32 row, segment after segment."""
    out = _launch_row_stream(w, list(segments), block_d, "row_stream_segments")
    row_stream_segments_cuda.launches += 1
    return out


row_stream_segments_cuda.launches = 0

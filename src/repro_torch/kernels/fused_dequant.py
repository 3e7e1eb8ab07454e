"""The quantized ColRel aggregation over the int8 wire stack as a
hand-written Hopper kernel, and its plain PyTorch version.

Replaces ``repro/kernels/fused_dequant.py``:

* :func:`fused_dequant_aggregate_cuda` for
  ``fused_dequant_aggregate_pallas`` — the PS delta over the int8 affine
  wire form ``x = q * s`` (one f32 scale per client row)::

      delta = (1/n) tau_up @ ((A * tau_dd^T) @ (q * s))
            = ((1/n) tau_up @ (A * tau_dd^T) * s^T) @ q

  The scales fold into the collapsed weight row in shared memory, so the
  int8 stack crosses device memory once and no f32 stack exists.
* :func:`fold_dequant_scales` — that fold, hoisted out for the segment
  path: the caller folds once a round and streams each int8 segment
  through :func:`repro_torch.kernels.ops.dequant_row_stream` (the ported
  ``row_stream`` kernel, as the reference's ``dequant_row_stream_pallas``
  delegates to ``row_stream_pallas``).

The kernel lives in ``csrc/fused_aggregate.cu`` beside the kernel it
extends.  The plain version folds and sums in the kernel's order, so the
two agree to the bit, and the segment path gives exactly the columns of
the monolithic one.

Two readings for its timing: :func:`dequant_grid`, the grid the kernel
takes for an (n, d) stack, and :func:`launch_floor_cuda`, an empty kernel
of a given grid (what a lone launch costs the timing harness).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_aggregate import (
    _check_block,
    _check_stack,
    _operand,
    _raise_on,
    collapsed_weight_row,
    row_stream_plain,
)

__all__ = [
    "fold_dequant_scales",
    "fused_dequant_aggregate_plain",
    "fused_dequant_aggregate_cuda",
    "dequant_grid",
    "launch_floor_cuda",
]


def fold_dequant_scales(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``w * scale`` as an (n,) f32 row: the fold the kernel performs in
    shared memory, done once a round for the segment path."""
    return w.float().reshape(-1) * scale.float().reshape(-1)


def fused_dequant_aggregate_plain(A: torch.Tensor, tau_up: torch.Tensor,
                                  tau_dd: torch.Tensor, q: torch.Tensor,
                                  scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_dequant_aggregate_cuda`: (d,) f32."""
    ws = fold_dequant_scales(collapsed_weight_row(A, tau_up, tau_dd), scale)
    return row_stream_plain(ws, q)


def fused_dequant_aggregate_cuda(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                                 q: torch.Tensor, scale: torch.Tensor, *,
                                 block_d: int = 2048) -> torch.Tensor:
    """One-pass quantized ColRel PS delta for an (n, d) int8 CUDA stack
    with (n,) or (n, 1) f32 row scales; returns the (d,) f32 delta.  Each
    CUDA block covers ``block_d`` columns."""
    _check_stack(q, (torch.int8,), "fused_dequant_aggregate")
    _check_block(block_d)
    n, d = q.shape
    dev = q.device
    a = _operand(A, (n, n), dev, "A")
    tu = _operand(tau_up, (n,), dev, "tau_up")
    td = _operand(tau_dd, (n, n), dev, "tau_dd")
    s = _operand(scale.reshape(-1), (n,), dev, "scale")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_fused_dequant_aggregate(
            a.data_ptr(), tu.data_ptr(), td.data_ptr(), s.data_ptr(), q.data_ptr(),
            out.data_ptr(), n, d, block_d, 1.0 / n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "fused_dequant_aggregate")
    fused_dequant_aggregate_cuda.launches += 1
    return out


fused_dequant_aggregate_cuda.launches = 0


def dequant_grid(n: int, d: int, *, block_d: int = 2048) -> dict:
    """The grid :func:`fused_dequant_aggregate_cuda` takes on the card for a
    16-byte aligned (n, d) int8 stack: blocks, columns a block, the threads
    of a block that hold columns, blocks an SM holds, SMs, and the most and
    fewest blocks an SM gets when the blocks are dealt out evenly."""
    _check_block(block_d)
    g = (ctypes.c_int64 * 5)()
    lib = build.library()
    _raise_on(lib.repro_fused_dequant_grid(n, d, block_d, g), lib, "dequant_grid")
    blocks, cols, per_thread, per_sm, sms = (int(v) for v in g)
    return dict(blocks=blocks, cols=cols, threads_with_columns=-(-cols // per_thread),
                blocks_per_sm=per_sm, sms=sms, most_blocks_an_sm=-(-blocks // sms),
                fewest_blocks_an_sm=blocks // sms)


def launch_floor_cuda(blocks: int) -> None:
    """An empty kernel of ``blocks`` blocks of 256 threads on the current
    stream: the timing harness's floor for a lone launch of that grid."""
    lib = build.library()
    _raise_on(lib.repro_launch_floor(blocks, torch.cuda.current_stream().cuda_stream), lib,
              "launch_floor")

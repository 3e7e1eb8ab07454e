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
"""

from __future__ import annotations

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

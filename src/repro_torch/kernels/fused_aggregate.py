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

The kernels live in ``csrc/fused_aggregate.cu`` (design and bound in its
header).  Each wrapper checks its inputs, launches on the current stream
without synchronising, and counts its launches in ``launches``.  It takes
CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain versions below.

The plain versions run the kernels' arithmetic in the kernels' order —
weights collapsed over i in order, then rows accumulated in order, each
product and sum rounded on its own — so on any device they give the
kernels' result to the bit, and a per-segment pass gives exactly the
columns of the monolithic one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = [
    "mixing_mask",
    "collapsed_weight_row",
    "fused_aggregate_plain",
    "row_stream_plain",
    "fused_aggregate_cuda",
    "row_stream_cuda",
]

# element type codes of csrc/fused_aggregate.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the kernels keep the (n,) weight row in dynamic shared memory; 4096
# floats stay well inside the 48 KB a launch gets without opting in
_MAX_N = 4096


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


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.repro_error_string(err).decode()} ({err})")


def fused_aggregate_cuda(A: torch.Tensor, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                         updates: torch.Tensor, *, block_d: int = 2048) -> torch.Tensor:
    """One-pass ColRel PS delta ``(1/n) tau_up @ ((A * tau_dd^T) @ updates)``
    for an (n, d) f32 or bf16 CUDA stack; returns the (d,) f32 delta.
    Each CUDA block covers ``block_d`` columns."""
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


def row_stream_cuda(w: torch.Tensor, segment: torch.Tensor, *,
                    block_d: int = 2048) -> torch.Tensor:
    """One segment's PS-delta columns ``w @ segment`` for an (n, d_i) f32,
    bf16 or int8 CUDA segment; returns (d_i,) f32."""
    _check_stack(segment, tuple(_DTYPE_CODES), "row_stream")
    _check_block(block_d)
    n, d = segment.shape
    dev = segment.device
    wf = _operand(w, (n,), dev, "w")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_row_stream(
            wf.data_ptr(), segment.data_ptr(), out.data_ptr(), n, d, block_d,
            _DTYPE_CODES[segment.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "row_stream")
    row_stream_cuda.launches += 1
    return out


row_stream_cuda.launches = 0

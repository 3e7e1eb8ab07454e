"""Block-sparse clustered relaying as hand-written Hopper kernels, and their
plain PyTorch versions.

Replaces ``repro/kernels/relay_block.py``; under clustering only the C
diagonal ``(m, m)`` blocks of the mixing matrix carry weight, so these
index the ``(C, m, m)`` block tensors directly and the dense (n, n) mask
never exists:

* :func:`block_relay_mix_cuda` for ``block_relay_mix_pallas`` — the
  per-cluster consensus ``Dx~_c = (A_c * tau_c^T) @ Dx_c``, (n, d) in the
  stack's dtype.
* :func:`block_fused_aggregate_cuda` for ``block_fused_aggregate_pallas``
  — the one-pass PS delta ``(1/n) sum_c tau_up_c @ ((A_c * tau_c^T) @
  Dx_c)``, (d,) f32, the stack read once through the row reduction of
  kernels 1-2: the per-cluster weight rows are collapsed once into an (n,)
  row by a small kernel, and the stream is launched behind it so that its
  first loads start while the row is made (n = 16,384 runs).
* :func:`block_row_stream_cuda` for ``block_row_stream_pallas`` —
  ``sum_c w_c @ segment_c`` for one ``(n, d_i)`` leaf segment with the
  ``(C, m)`` rows given, so the monolithic stack never has to exist.
* :func:`block_row_stream_segments_cuda` — the same function over a
  round's whole segment list in one launch, writing one ``(d,)`` row: the
  segmented clustered path makes one launch a round where it made one per
  leaf.  It runs kernel 2's grouped body with the ``(C, m)`` rows laid end
  to end as one ``(n,)`` row, at any n (at most
  :data:`~repro_torch.kernels.fused_aggregate.MAX_SEGMENTS` segments).

The kernels live in ``csrc/relay_block.cu`` (design and bound in its
header); the dense ``relay_mix`` shares its mix kernel
(:mod:`repro_torch.kernels.relay_mix`).  Each wrapper checks its inputs,
launches on the current stream without synchronising, counts its
launches in ``launches`` and takes CUDA tensors only;
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain versions.

The plain versions run the kernels' arithmetic in the kernels' order:
the collapse sums over i in order, the stream over rows in global order
(clusters laid end to end), the mix over j in order, each product and sum
rounded on its own.  So kernel and plain version agree to the bit, a
per-segment pass gives exactly the columns of the monolithic one, the
grouped plain version is the per-segment loop, and at C = 1 the
aggregation is the dense ``fused_aggregate`` to the bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_aggregate import (
    _check_block,
    _check_segments,
    _operand,
    _raise_on,
    _same_stack,
    _table,
    _weighted_rows,
)

__all__ = [
    "block_mixing_mask",
    "block_collapsed_weight_row",
    "block_relay_mix_plain",
    "block_fused_aggregate_plain",
    "block_row_stream_plain",
    "block_row_stream_segments_plain",
    "block_relay_mix_cuda",
    "block_fused_aggregate_cuda",
    "block_row_stream_cuda",
    "block_row_stream_segments_cuda",
]

# element type codes of csrc/relay_block.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the relay mixes keep one (m, m) mask in shared memory: m*m floats within
# the 48 KB a launch gets without opting in
MAX_MIX_M = 110


def block_mixing_mask(Ab: torch.Tensor, tau_b: torch.Tensor) -> torch.Tensor:
    """Per-cluster realized mask ``A_c * tau_c^T``, (C, m, m) f32."""
    return Ab.float() * tau_b.float().transpose(1, 2)


def block_collapsed_weight_row(Ab: torch.Tensor, tau_up: torch.Tensor,
                               tau_b: torch.Tensor) -> torch.Tensor:
    """The per-cluster ColRel collapse ``w_c = (1/n) tau_c @ (A_c *
    tau_c^T)`` as a (C, m) f32 tensor, summed over i in order exactly as
    the collapse kernel does."""
    C, m, _ = Ab.shape
    mask = block_mixing_mask(Ab, tau_b)
    t = tau_up.float().reshape(C, m)
    acc = torch.zeros((C, m), dtype=torch.float32, device=mask.device)
    for i in range(m):
        acc = acc + t[:, i, None] * mask[:, i, :]
    return acc * (1.0 / (C * m))


def mix_plain(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out_c = mask_c @ x_c`` for a (C, m, m) f32 mask and an (n, d)
    stack, summed over j in order; (n, d) in the stack's dtype."""
    C, m, _ = mask.shape
    n, d = x.shape
    xc = x.reshape(C, m, d)
    acc = torch.zeros((C, m, d), dtype=torch.float32, device=x.device)
    for j in range(m):
        acc += mask[:, :, j, None] * xc[:, j, None, :].float()
    return acc.reshape(n, d).to(x.dtype)


def block_relay_mix_plain(Ab: torch.Tensor, tau_b: torch.Tensor,
                          updates: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`block_relay_mix_cuda`: (n, d) in the
    stack's dtype."""
    return mix_plain(block_mixing_mask(Ab, tau_b), updates)


def block_fused_aggregate_plain(Ab: torch.Tensor, tau_up: torch.Tensor,
                                tau_b: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`block_fused_aggregate_cuda`: (d,) f32."""
    return _weighted_rows(block_collapsed_weight_row(Ab, tau_up, tau_b).reshape(-1), updates)


def block_row_stream_plain(w: torch.Tensor, segment: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`block_row_stream_cuda`: (d_i,) f32."""
    return _weighted_rows(w.float().reshape(-1), segment)


def block_row_stream_segments_plain(w: torch.Tensor, segments: Sequence[torch.Tensor]
                                    ) -> torch.Tensor:
    """Plain version of :func:`block_row_stream_segments_cuda`: the
    per-segment rows one after another, (sum d_i,) f32."""
    return torch.cat([block_row_stream_plain(w, s) for s in segments])


# -- the CUDA wrappers -------------------------------------------------------


def check_stack(x: torch.Tensor, n: int, what: str) -> None:
    """A contiguous (n, d) f32 or bf16 CUDA stack with d >= 1."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes a CUDA tensor, got one on {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    if x.ndim != 2 or x.shape[0] != n or x.shape[1] < 1:
        raise ValueError(f"{what}: needs an ({n}, d) stack with d >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the stack must be contiguous")


def _clusters(Ab: torch.Tensor, what: str):
    if Ab.ndim != 3 or Ab.shape[1] != Ab.shape[2] or Ab.shape[0] < 1 or Ab.shape[1] < 1:
        raise ValueError(f"{what}: needs (C, m, m) blocks, got {tuple(Ab.shape)}")
    return Ab.shape[0], Ab.shape[1]


def block_relay_mix_cuda(Ab: torch.Tensor, tau_b: torch.Tensor,
                         updates: torch.Tensor) -> torch.Tensor:
    """Per-cluster consensus ``(A_c * tau_c^T) @ X_c`` for an (n, d) f32 or
    bf16 CUDA stack, n = C*m, m <= 110; returns (n, d) in the stack's
    dtype."""
    C, m = _clusters(Ab, "block_relay_mix")
    if m > MAX_MIX_M:
        raise ValueError(f"block_relay_mix: the (m, m) mask lives in shared memory, "
                         f"m <= {MAX_MIX_M}, got m={m}")
    check_stack(updates, C * m, "block_relay_mix")
    d, dev = updates.shape[1], updates.device
    a = _operand(Ab, (C, m, m), dev, "Ab")
    tb = _operand(tau_b, (C, m, m), dev, "tau_b")
    out = torch.empty_like(updates)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_block_relay_mix(
            a.data_ptr(), tb.data_ptr(), updates.data_ptr(), out.data_ptr(), C, m, d,
            DTYPE_CODES[updates.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "block_relay_mix")
    block_relay_mix_cuda.launches += 1
    return out


block_relay_mix_cuda.launches = 0


def block_fused_aggregate_cuda(Ab: torch.Tensor, tau_up: torch.Tensor, tau_b: torch.Tensor,
                               updates: torch.Tensor, *, block_d: int = 2048) -> torch.Tensor:
    """One-pass blocked ColRel PS delta ``(1/n) sum_c tau_up_c @ ((A_c *
    tau_c^T) @ X_c)`` for an (n, d) f32 or bf16 CUDA stack, n = C*m;
    returns the (d,) f32 delta.  Each CUDA block of the stream covers at
    most ``block_d`` columns."""
    C, m = _clusters(Ab, "block_fused_aggregate")
    n = C * m
    check_stack(updates, n, "block_fused_aggregate")
    _check_block(block_d)
    d, dev = updates.shape[1], updates.device
    a = _operand(Ab, (C, m, m), dev, "Ab")
    tu = _operand(tau_up, (n,), dev, "tau_up")
    tb = _operand(tau_b, (C, m, m), dev, "tau_b")
    w = torch.empty(n, dtype=torch.float32, device=dev)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_block_fused_aggregate(
            a.data_ptr(), tu.data_ptr(), tb.data_ptr(), updates.data_ptr(), w.data_ptr(),
            out.data_ptr(), C, m, d, block_d, DTYPE_CODES[updates.dtype], 1.0 / n,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "block_fused_aggregate")
    block_fused_aggregate_cuda.launches += 1
    return out


block_fused_aggregate_cuda.launches = 0


def block_row_stream_cuda(w: torch.Tensor, segment: torch.Tensor, *,
                          block_d: int = 2048) -> torch.Tensor:
    """One segment's blocked PS-delta columns ``sum_c w_c @ segment_c`` for
    (C, m) rows and an (n, d_i) f32 or bf16 CUDA segment, n = C*m;
    returns (d_i,) f32."""
    if w.ndim != 2:
        raise ValueError(f"block_row_stream: needs (C, m) weight rows, got {tuple(w.shape)}")
    n = w.shape[0] * w.shape[1]
    check_stack(segment, n, "block_row_stream")
    _check_block(block_d)
    d, dev = segment.shape[1], segment.device
    wf = _operand(w, tuple(w.shape), dev, "w")
    out = torch.empty(d, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_block_row_stream(
            wf.data_ptr(), segment.data_ptr(), out.data_ptr(), n, d, block_d,
            DTYPE_CODES[segment.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "block_row_stream")
    block_row_stream_cuda.launches += 1
    return out


block_row_stream_cuda.launches = 0


def block_row_stream_segments_cuda(w: torch.Tensor, segments: Sequence[torch.Tensor], *,
                                   block_d: int = 2048) -> torch.Tensor:
    """A round's blocked PS-delta columns ``sum_c w_c @ segment_c`` in one
    launch: (C, m) rows and a list of (n, d_i) contiguous CUDA segments of
    one dtype (f32 or bf16), n = C*m; returns the (sum d_i,) f32 row,
    segment after segment."""
    what = "block_row_stream_segments"
    segments = list(segments)
    if w.ndim != 2:
        raise ValueError(f"{what}: needs (C, m) weight rows, got {tuple(w.shape)}")
    _check_segments(segments, what)
    for seg in segments:
        _same_stack(seg, segments[0], what)
    n = w.shape[0] * w.shape[1]
    if segments[0].shape[0] != n:
        raise ValueError(f"{what}: the weight rows give C*m = {n} clients, the segments "
                         f"have n = {segments[0].shape[0]}")
    for seg in segments:
        check_stack(seg, n, what)
    _check_block(block_d)
    dev = segments[0].device
    wf = _operand(w, tuple(w.shape), dev, "w")
    out = torch.empty(sum(s.shape[1] for s in segments), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_block_row_stream_segments(
            wf.data_ptr(), _table((s.data_ptr(), s.shape[1]) for s in segments), len(segments),
            out.data_ptr(), n, block_d, DTYPE_CODES[segments[0].dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, what)
    block_row_stream_segments_cuda.launches += 1
    return out


block_row_stream_segments_cuda.launches = 0

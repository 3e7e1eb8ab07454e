"""Causal flash attention as a hand-written Hopper kernel, and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py``: :func:`flash_attention_cuda`
for ``flash_attention_pallas``, causal online-softmax attention over
``(BH, T, D)`` q, k, v (f32 or bf16, f32 inside), the output in q's dtype.
One CUDA block owns one (bh, 128-row query tile) pair, keeps the running
max, sum and accumulator in registers, stages K and V tiles in shared
memory and stops at the diagonal tile (design and bound in
``csrc/flash_attention.cu``).  The kernel masks a ragged tail in T
itself; the reference's divisibility rule lives in
:func:`repro_torch.kernels.ops.flash_attention`.

The wrapper checks its inputs, launches on the current stream without
synchronising, counts its launches in ``launches`` and takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version, the dense softmax of ``repro/kernels/ref.py:flash_attention_ref``.
The two agree within 2e-5 in f32, not to the bit: the kernel's online
softmax rescales in another order.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_aggregate import _raise_on

__all__ = ["HEAD_DIMS", "flash_attention_plain", "flash_attention_cuda"]

# element type codes of csrc/flash_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernel is compiled for
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """q (BH, T, D), k/v (BH, S, D): dense softmax attention in f32, the
    output in q's dtype."""
    T, D = q.shape[1], q.shape[2]
    S = k.shape[1]
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) / math.sqrt(D)
    if causal:
        idx = torch.arange(max(T, S), device=q.device)
        mask = idx[:T, None] >= idx[None, :S]
        s = s.masked_fill(~mask[None], -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", w, v.float()).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of (BH, T, D) CUDA tensors of one dtype (f32 or
    bf16), D in (32, 64, 128), k and v of q's shape; any T >= 1.  Returns
    (BH, T, D) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel takes "
                             "CUDA tensors")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; f32 and bf16 are compiled")
        if t.ndim != 3 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous (BH, T, D) tensor, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype \
            or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must share shape, dtype and device (causal "
                         f"self-attention, S == T), got {tuple(q.shape)} {q.dtype}, "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    BH, T, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not compiled; the kernel takes "
                         f"D in {HEAD_DIMS}")
    if BH < 1 or T < 1 or T > 65535 * 128:
        raise ValueError(f"flash_attention: BH={BH}, T={T} outside the kernel's grid")
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        BH, T, D, _DTYPE_CODES[q.dtype],
                                        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0

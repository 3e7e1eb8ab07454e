"""Causal flash attention as a hand-written Hopper kernel, and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py``: :func:`flash_attention_cuda`
for ``flash_attention_pallas``, causal online-softmax attention, the
output in q's dtype.  It takes q (B, T, H, D) and k, v (B, T, KV, D) as
strided views (last dim contiguous, rows 16-byte aligned): query head h
reads kv head ``h // (H // KV)`` in place, and the output is a (B, T, H,
D) tensor, so grouped-query attention needs no broadcast and no
transpose.  (BH, T, D) tensors are the case H = KV = 1.  bf16 takes the
scores on the CUDA cores in f32 and P V on the tensor cores (wgmma, a
TMA-fed K/V ring in shared memory, P split into three bf16 parts); f32
runs on the CUDA cores in f32 (design and bound in
``csrc/flash_attention.cu``).  The kernel masks a ragged tail in T
itself; the reference's divisibility rule lives in
:func:`repro_torch.kernels.ops.flash_attention`.

The wrapper checks its inputs, launches on the current stream without
synchronising, counts its launches in ``launches`` and takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version, the dense softmax of ``repro/kernels/ref.py:flash_attention_ref``.
The two agree within 2e-5 in f32 and 2e-2 in bf16, not to the bit: the
kernel's online softmax rescales and sums in another order.
"""

from __future__ import annotations

import ctypes
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


def _heads_view(t: torch.Tensor) -> torch.Tensor:
    """A (BH, T, D) tensor as the (B=BH, T, 1, D) view the kernel takes."""
    return t.unsqueeze(2) if t.ndim == 3 else t


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, time, head) element strides of a (B, T, heads, D) view; a
    dim of size 1 is given the row length, a stride any row alignment
    accepts."""
    return tuple(s if n > 1 else t.shape[-1] for n, s in zip(t.shape[:3], t.stride()[:3]))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of CUDA tensors of one dtype (f32 or bf16): q (B, T,
    H, D) with k and v (B, T, KV, D), H a multiple of KV, or all three (BH,
    T, D); D in (32, 64, 128); any T >= 1.  Any strides with the last dim
    contiguous and rows 16-byte aligned.  Returns a new contiguous tensor of
    q's shape and dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel takes "
                             "CUDA tensors")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; f32 and bf16 are compiled")
        if t.ndim not in (3, 4) or t.ndim != q.ndim:
            raise ValueError(f"flash_attention: {name} must be (BH, T, D) or (B, T, heads, D) "
                             f"as q is, got shape {tuple(t.shape)}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"flash_attention: {name} must be contiguous along its last dim "
                             f"(D), got shape {tuple(t.shape)} strides {t.stride()}")
    kv_shape = q.shape if q.ndim == 3 else (*q.shape[:2], k.shape[2], q.shape[3])
    if k.shape != kv_shape or v.shape != kv_shape or k.dtype != q.dtype \
            or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must share shape (k and v may have fewer "
                         f"heads), dtype and device (causal self-attention, S == T), got "
                         f"{tuple(q.shape)} {q.dtype}, {tuple(k.shape)} {k.dtype}, "
                         f"{tuple(v.shape)} {v.dtype}")
    q4, k4, v4 = (_heads_view(t) for t in (q, k, v))
    B, T, H, D = q4.shape
    KV = k4.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not compiled; the kernel takes "
                         f"D in {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} kv heads")
    if B < 1 or T < 1 or B * H > 2**31 - 1 or T > 65535 * 128:
        raise ValueError(f"flash_attention: B*H={B * H}, T={T} outside the kernel's grid")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    o4 = _heads_view(out)
    elt = q.element_size()
    strides = [s for t in (q4, k4, v4, o4) for s in _strides(t)]
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.data_ptr() % 16 or any(s <= 0 or s * elt % 16 for s in _strides(t)):
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned (base and "
                             f"positive strides), got strides {t.stride()}")
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        (ctypes.c_int64 * 12)(*strides), B, H, KV, T, D,
                                        _DTYPE_CODES[q.dtype],
                                        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0

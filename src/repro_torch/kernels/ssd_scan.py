"""The chunked SSD (Mamba2) recurrence as a hand-written Hopper kernel, and
its plain PyTorch version.

Replaces ``repro/kernels/ssd_scan.py``: :func:`ssd_scan_cuda` for
``ssd_scan_pallas``.  For every ``(b, h)`` slice, from a zero state, chunk
by chunk with ``c`` the chunk-local inclusive cumsum of the log decays::

    y_t = sum_{s<=t} (q_t . k_s) exp(min(c_t - c_s, 0)) v_s + exp(c_t) q_t @ S
    S'  = exp(c_last) S + sum_s k_s exp(min(c_last - c_s, 0)) v_s^T

q, k ``(..., T, Dk)``, v ``(..., T, Dv)`` f32 or bf16, log_decay ``(..., T)``
f32 and non-positive; the output ``(..., T, Dv)`` in q's dtype; f32 inside.
One CUDA block owns one slice and loops over its chunks, carrying the
state itself; bf16 runs its products on the tensor cores, f32 on the CUDA
cores (design and bound in ``csrc/ssd_scan.cu``).

The leading dims ``...`` are ``(BH,)``, the reference's interface, or
``(B, H)``.  The kernel takes strided views in the second form, so Mamba
calls it on ``(B, T, N)`` tensors broadcast over the heads and on
``(B, T, H, P)`` values seen as ``(B, H, T, P)`` without copying them; the
output is laid out as v is.

The wrapper checks its inputs, launches on the current stream without
synchronising, counts its launches in ``launches`` and takes CUDA tensors
only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the plain
version.  The two agree within 5e-4 in f32 (the reference's bound for its
kernel) and 2e-2 in bf16, not to the bit: the products sum in another
order, and the bf16 kernel keeps its f32 operands as two bf16 parts.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_aggregate import _raise_on

__all__ = ["MAX_CHUNK", "MAX_DK", "VALUE_DIMS", "ssd_scan_plain", "ssd_scan_cuda"]

# element type codes of csrc/ssd_scan.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# what the kernel is built for: a chunk of at most 64 tokens, key dims up to
# 32, value dims that 256 threads cover as 4-column groups
MAX_CHUNK = 64
MAX_DK = 32
VALUE_DIMS = (4, 8, 16, 32, 64)
NEG_INF = -1e30


def ssd_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor,
                   *, chunk: int = 64) -> torch.Tensor:
    """The Pallas kernel's arithmetic in batched matmuls: q, k (..., T, Dk),
    v (..., T, Dv), log_decay (..., T) -> (..., T, Dv) in q's dtype."""
    *lead, T, Dk = q.shape
    Dv = v.shape[-1]
    if T % chunk:
        raise ValueError(f"ssd_scan: T={T} is not a whole number of chunks of {chunk}")
    N = T // chunk
    qf = q.reshape(-1, N, chunk, Dk).float()
    kf = k.reshape(-1, N, chunk, Dk).float()
    vf = v.reshape(-1, N, chunk, Dv).float()
    c = torch.cumsum(log_decay.reshape(-1, N, chunk).float(), dim=-1)  # chunk-local, inclusive

    # intra-chunk: scores[t, s] = (q_t . k_s) exp(c_t - c_s), s <= t
    scores = qf @ kf.transpose(-1, -2)
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    dec = torch.where(causal, torch.clamp(c[..., :, None] - c[..., None, :], max=0.0), NEG_INF)
    # (the Pallas kernel casts the weighted scores to v's dtype, which is f32
    # there: it widens v first)
    y = (scores * torch.exp(dec)) @ vf

    # inter-chunk: exp(c_t) q_t @ S, S carried chunk to chunk from zero
    c_last = c[..., -1]
    kdec = kf * torch.exp(torch.clamp(c_last[..., None] - c, max=0.0))[..., None]
    chunk_states = kdec.transpose(-1, -2) @ vf  # (BH, N, Dk, Dv)
    S = torch.zeros(qf.shape[0], Dk, Dv, dtype=torch.float32, device=q.device)
    inter = []
    for n in range(N):
        inter.append(torch.exp(c[:, n])[..., None] * (qf[:, n] @ S))
        S = torch.exp(c_last[:, n])[:, None, None] * S + chunk_states[:, n]
    y = y + torch.stack(inter, dim=1)
    return y.reshape(*lead, T, Dv).to(q.dtype)


def _heads_split(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (BH, ...) operand as the (1, BH, ...) view the kernel addresses."""
    return t.unsqueeze(0) if t.ndim == ndim - 1 else t


def ssd_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor,
                  *, chunk: int = 64) -> torch.Tensor:
    """The SSD recurrence of CUDA tensors q, k (..., T, Dk), v (..., T, Dv)
    of one dtype (f32 or bf16), log_decay (..., T) f32, ``...`` being
    (BH,) or (B, H); any strides, with unit stride along Dk and Dv.
    Dk <= 32, Dv in (4, 8, 16, 32, 64), T a whole number of chunks of at
    most 64 tokens.  Returns (..., T, Dv) in q's dtype, laid out as v."""
    for name, t in (("q", q), ("k", k), ("v", v), ("log_decay", log_decay)):
        if not t.is_cuda:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, the kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ssd_scan: q, k, v must share one dtype of {tuple(_DTYPE_CODES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if log_decay.dtype != torch.float32:
        raise TypeError(f"ssd_scan: log_decay must be float32, got {log_decay.dtype}")
    if q.ndim not in (3, 4) or k.shape != q.shape or v.ndim != q.ndim \
            or v.shape[:-1] != q.shape[:-1] or log_decay.shape != q.shape[:-1]:
        raise ValueError(f"ssd_scan: needs q, k (..., T, Dk), v (..., T, Dv), log_decay "
                         f"(..., T) with ... = (BH,) or (B, H), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(log_decay.shape)}")
    T, Dk, Dv = q.shape[-2], q.shape[-1], v.shape[-1]
    if not 1 <= Dk <= MAX_DK or Dv not in VALUE_DIMS:
        raise ValueError(f"ssd_scan: Dk={Dk}, Dv={Dv}; the kernel takes Dk <= {MAX_DK} and "
                         f"Dv in {VALUE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunks of {chunk} tokens; the kernel takes 1 to at most "
                         f"{MAX_CHUNK}")
    if T % chunk:
        raise ValueError(f"ssd_scan: T={T} is not a whole number of chunks of {chunk}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("ssd_scan: q, k and v need unit stride along their last dim")
    out = torch.empty_like(v)
    q4, k4, v4, o4 = (_heads_split(t, 4) for t in (q, k, v, out))
    l3 = _heads_split(log_decay, 3)
    B, H = q4.shape[0], q4.shape[1]
    if B * H > 2**31 - 1 or T > 2**31 - 1:
        raise ValueError(f"ssd_scan: B*H={B * H}, T={T} outside the kernel's grid")
    strides = (ctypes.c_int64 * 15)(*q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
                                    *l3.stride(), *o4.stride()[:3])
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_ssd_scan(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
                                 out.data_ptr(), strides, B * H, H, T, Dk, Dv, chunk,
                                 _DTYPE_CODES[q.dtype],
                                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return out


ssd_scan_cuda.launches = 0

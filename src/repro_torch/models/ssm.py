"""Linear-recurrence sequence mixers: the chunked SSD (Mamba2-style) half.

The counterpart of the SSD functions of ``repro.models.ssm``.  The
sequence is split into chunks of ``Q`` tokens; within a chunk the
recurrence is evaluated as masked matmuls, and a loop over the chunks
carries the recurrent state (the reference's ``lax.scan``).  All
exponentials are differences of cumulative log-decays with non-positive
exponents, so the arithmetic cannot overflow.

Conventions: q/k (B, T, H, Dk), v (B, T, H, Dv), log decays (B, T, H);
``S_t = a_t S_{t-1} + k_t v_t^T``, ``y_t = q_t S_t``.

The zero-state case is also the hand-written ``ssd_scan`` kernel
(:func:`repro_torch.kernels.ops.ssd_scan`), which the Mamba prefill takes;
:func:`ssd_chunked` serves a given initial state.  The GLA half (RWKV6's
per-channel decay, ``gla_*``) is ported with RWKV (ROADMAP.md queue 1,
item 17, step 2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_chunked", "ssd_step", "ssd_reference"]


def _chunk(x: torch.Tensor, q: int) -> torch.Tensor:
    """(B, T, ...) -> (B, T//q, q, ...)."""
    b, t = x.shape[:2]
    if t % q:
        raise ValueError(f"seq len {t} not divisible by chunk {q}")
    return x.reshape(b, t // q, q, *x.shape[2:])


def ssd_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, loga: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """loga (B, T, H) non-positive log decays; state (B, H, Dk, Dv).
    Returns (y (B, T, H, Dv) in q's dtype, final state f32)."""
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    qc = _chunk(q, chunk).float()
    kc = _chunk(k, chunk).float()
    vc = _chunk(v, chunk).float()
    c = torch.cumsum(_chunk(loga, chunk).float(), dim=2)  # (B, N, Q, H) inclusive

    # intra-chunk: y_t += sum_{s<=t} exp(c_t - c_s) (q_t . k_s) v_s
    scores = torch.einsum("bnqhd,bnshd->bnhqs", qc, kc)
    ct = c.permute(0, 1, 3, 2)  # (B, N, H, Q)
    decay = ct[..., :, None] - ct[..., None, :]  # [b, n, h, t, s] = c_t - c_s
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=q.device))
    w = torch.exp(torch.where(tri, torch.clamp(decay, max=0.0), -torch.inf))
    y_intra = torch.einsum("bnhqs,bnshd->bnqhd", scores * w, vc)

    # chunk summaries: each chunk's state contribution sum_s exp(c_last - c_s) k_s v_s^T
    clast = c[:, :, -1, :]  # (B, N, H)
    kdec = kc * torch.exp(clast[:, :, None, :] - c)[..., None]
    chunk_states = torch.einsum("bnshd,bnshe->bnhde", kdec, vc)  # (B, N, H, Dk, Dv)

    S = (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=q.device) if state is None
         else state.float())
    qdec = qc * torch.exp(c)[..., None]  # (B, N, Q, H, Dk)
    y_inter = []
    for n in range(T // chunk):
        y_inter.append(torch.einsum("bqhd,bhde->bqhe", qdec[:, n], S))
        S = torch.exp(clast[:, n])[..., None, None] * S + chunk_states[:, n]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(B, T, H, Dv).to(q.dtype), S


def ssd_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, loga: torch.Tensor,
             state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode.  q/k (B, H, Dk), v (B, H, Dv), loga (B, H)."""
    a = torch.exp(loga.float())[..., None, None]
    S = a * state + torch.einsum("bhd,bhe->bhde", k.float(), v.float())
    y = torch.einsum("bhd,bhde->bhe", q.float(), S)
    return y.to(q.dtype), S


def ssd_reference(q, k, v, loga, state=None):
    """The sequential recurrence, token by token (the tests' oracle)."""
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    S = (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=q.device) if state is None
         else state.float())
    ys = []
    for t in range(T):
        y, S = ssd_step(q[:, t], k[:, t], v[:, t], loga[:, t], S)
        ys.append(y)
    return torch.stack(ys, dim=1), S

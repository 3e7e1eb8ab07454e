"""Linear-recurrence sequence mixers: chunked SSD (Mamba2-style) and
per-channel gated linear attention (RWKV6-style), plus one-token decode.

The counterpart of ``repro.models.ssm``.  The sequence is split into
chunks of ``Q`` tokens; within a chunk the recurrence is evaluated as
masked matmuls, and a loop over the chunks carries the recurrent state in
f32 (the reference's ``lax.scan``).  All exponentials are differences of
cumulative log-decays with non-positive exponents, so the arithmetic
cannot overflow.

Conventions: q/k (B, T, H, Dk), v (B, T, H, Dv).

* SSD (scalar decay a head, log decays (B, T, H)):
  ``S_t = a_t S_{t-1} + k_t v_t^T``, ``y_t = q_t S_t``;
* GLA (per-channel decay, log decays (B, T, H, Dk)):
  ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``,
  ``y_t = q_t (S_{t-1} + diag(u) k_t v_t^T)`` (RWKV6's form: the current
  token enters through the bonus ``u``).

The zero-state SSD case is also the hand-written ``ssd_scan`` kernel
(:func:`repro_torch.kernels.ops.ssd_scan`), which the Mamba prefill takes;
:func:`ssd_chunked` serves a given initial state.  The GLA recurrence has
no kernel in the reference either: it is plain PyTorch here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist.layout import fold_ready, grad_as, is_dtensor, merge_ready, settle

__all__ = ["ssd_chunked", "ssd_step", "ssd_reference", "gla_chunked", "gla_step",
           "gla_reference"]


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
    if is_dtensor(state):
        # on a mesh: products and a sum, no batched matmul (DTensor folds
        # the batch, sharded over two mesh dims, with the heads only into a
        # strided layout it cannot then use)
        S = a * state + k.float()[..., :, None] * v.float()[..., None, :]
        y = (q.float()[..., :, None] * S).sum(-2)
        return y.to(q.dtype), S
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


# ---------------------------------------------------------------------------
# GLA: per-channel decay with bonus (RWKV6-style), chunked
# ---------------------------------------------------------------------------


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor, state: Optional[torch.Tensor] = None,
                chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6's wkv with a per-channel, data-dependent decay.

    r/k/logw (B, T, H, Dk), logw <= 0; v (B, T, H, Dv); u (H, Dk) the
    bonus; state (B, H, Dk, Dv).  Returns (y (B, T, H, Dv) in r's dtype,
    final state f32).  The intra-chunk decay tensor is (B, N, H, Q, Q, Dk)
    in f32, a transient of the call."""
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    # on a mesh only the batch stays sharded, no sum pending: the chunked
    # einsums fold (batch, chunks, heads), and DTensor folds a sharded dim
    # only first
    r, k, v, logw = (settle(merge_ready(t, t.ndim)) for t in (r, k, v, logw))
    # (B, N, H, Q, D): chunked, heads before positions
    rt, kt, vt = (_chunk(x, chunk).float().transpose(2, 3) for x in (r, k, v))
    c = torch.cumsum(_chunk(logw, chunk).float().transpose(2, 3), dim=3)  # inclusive
    cprev = c - _chunk(logw, chunk).float().transpose(2, 3)  # decay before token t

    # intra-chunk, strictly causal: W[t, s] = sum_d r_td k_sd exp(cprev_t - c_s)_d;
    # the exponent is <= 0 for s < t, clamped for the masked s >= t
    dec = torch.exp(torch.clamp(cprev[..., :, None, :] - c[..., None, :, :], max=0.0))
    scores = (dec * rt[..., :, None, :] * kt[..., None, :, :]).sum(-1)
    del dec
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    y = torch.einsum("bnhts,bnhse->bnhte", scores, vt)
    # the bonus (current token): y_t += (r_t . (u * k_t)) v_t
    bonus = torch.einsum("bnhtd,hd,bnhtd->bnht", rt, u.float(), kt)
    y = y + bonus[..., None] * vt

    # inter-chunk: each chunk's state contribution, then a loop over chunks
    clast = c[..., -1, :]  # (B, N, H, Dk)
    kdec = kt * torch.exp(torch.clamp(clast[..., None, :] - c, max=0.0))
    chunk_states = torch.einsum("bnhsd,bnhse->bnhde", kdec, vt)  # (B, N, H, Dk, Dv)
    rdec = rt * torch.exp(cprev)  # exp(cprev) <= 1

    S = (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=r.device) if state is None
         else state.float())
    y_inter = []
    for n in range(T // chunk):
        y_inter.append(torch.einsum("bhqd,bhde->bhqe", rdec[:, n], S))
        S = torch.exp(clast[:, n])[..., None] * S + chunk_states[:, n]
    y = y + torch.stack(y_inter, dim=1)
    y = y.transpose(2, 3).reshape(B, T, H, Dv).to(r.dtype)
    # on a mesh the gradient comes back laid out as y (the batch sharded)
    return grad_as(y, y), S


def gla_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token RWKV6 decode.  r/k/logw (B, H, Dk), v (B, H, Dv), u (H, Dk)."""
    # on a mesh the batched matmuls fold (batch, heads): one of them sharded
    r, k, v, logw, state = (fold_ready(t, (0, 1)) for t in (r, k, v, logw, state))
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    y = torch.einsum("bhd,bhde->bhe", rf, state + u.float()[None, :, :, None] * kv)
    S = torch.exp(logw.float())[..., None] * state + kv
    return y.to(r.dtype), S


def gla_reference(r, k, v, logw, u, state=None):
    """The sequential recurrence, token by token (the tests' oracle)."""
    B, T, H, Dk = r.shape
    Dv = v.shape[-1]
    S = (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=r.device) if state is None
         else state.float())
    ys = []
    for t in range(T):
        y, S = gla_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, S)
        ys.append(y)
    return torch.stack(ys, dim=1), S

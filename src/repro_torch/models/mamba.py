"""Mamba block (Mamba2/SSD-style selective SSM), used by the jamba hybrid.

The counterpart of ``repro.models.mamba``.  Per layer: a fused
in-projection -> (gate z, conv channels xBC, dt), a causal depthwise conv,
the scalar-per-head decay ``a_t = exp(-exp(A_log) * dt_t)``, the chunked
SSD mixer, a gated RMS norm and the out-projection.

The one departure from the reference is where the SSD mixer runs.  The
reference always takes the jnp ``ssm.ssd_chunked``.  Here a forward from a
zero state (``state=None``, the only case the hybrid's forward uses) takes
the hand-written kernel :func:`repro_torch.kernels.ops.ssd_scan`, on views
of the mixer's tensors; a forward from a given state takes
:func:`repro_torch.models.ssm.ssd_chunked`.

Decode carries two states per layer: the conv window (the last
``d_conv - 1`` inputs) and the SSD state (B, H, d_state, head_dim).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as ssd_scan_mod
from repro_torch.models import ssm
from repro_torch.models.common import ModelConfig, Params, dense_init

__all__ = ["init_mamba", "mamba_forward", "init_mamba_state", "mamba_step"]


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    H = cfg.n_ssm_heads
    P = d_in // H  # head dim (the "value" dim of SSD)
    N = cfg.ssm_d_state  # the "key" dim of SSD
    conv_ch = d_in + 2 * N  # x, B, C all pass through the conv
    return d_in, H, P, N, conv_ch


def init_mamba(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """One layer's params on ``gen``'s device, drawn from ``gen``."""
    d, dev = cfg.d_model, gen.device
    d_in, H, P, N, conv_ch = _dims(cfg)
    dt_floor = 1e-3
    w_in = dense_init(gen, (d, 2 * d_in + 2 * N + H), cfg.tdtype)
    conv_w = dense_init(gen, (cfg.ssm_conv, conv_ch), cfg.tdtype, scale=0.5)
    w_out = dense_init(gen, (d_in, d), cfg.tdtype)
    u = torch.empty(H, dtype=torch.float32, device=dev).uniform_(math.log(dt_floor), 0.0,
                                                                 generator=gen)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=cfg.tdtype, device=dev),
        # softplus^-1 of dt drawn log-uniform in [dt_floor, 1]
        "dt_bias": torch.log(torch.exp(torch.exp(u)) - 1.0),
        "A_log": torch.log(1.0 + torch.arange(1, H + 1, dtype=torch.float32, device=dev) % 16),
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "norm_scale": torch.ones(d_in, dtype=cfg.tdtype, device=dev),
        "w_out": w_out,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (K, C); the reference's
    unrolled window sum, term for term."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + T, :] * w[i]
    return out + b


def _split(cfg: ModelConfig, h: torch.Tensor):
    d_in, H, P, N, _ = _dims(cfg)
    z, xBC, dt = torch.split(h, [d_in, d_in + 2 * N, H], dim=-1)
    return z, xBC, dt


def _gated_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    x = x * F.silu(z)
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * scale


def mamba_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Optional[Params] = None, *,
                  ssd_kernel: bool = True) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, T, d) -> (y (B, T, d), final state or None).  ``ssd_kernel``
    False runs a zero-state forward through the kernel's plain version on
    any device (the hybrid's forward without ``use_flash``)."""
    B, T, d = x.shape
    d_in, H, P, N, conv_ch = _dims(cfg)
    h = x @ p["w_in"]
    z, xBC_pre, dt = _split(cfg, h)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"], p["conv_b"]))
    xs, Bc, Cc = torch.split(xBC, [d_in, N, N], dim=-1)
    v = xs.reshape(B, T, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, T, H)
    loga = -torch.exp(p["A_log"]) * dt
    v_in = v * dt[..., None].to(v.dtype)
    chunk = min(cfg.ssm_chunk, T)
    if state is None:
        # The reference runs ssm.ssd_chunked here (its mamba.py:98) and drops
        # the final state; from a zero state that is ssd_scan's function.  Its
        # (B*H, T, .) operands are views split as (B, H, T, .): Bc and Cc
        # broadcast over the heads, v and y in (B, T, H, P) storage.
        k, q = (t[:, None].expand(B, H, T, N) for t in (Bc, Cc))
        scan = kops.ssd_scan if ssd_kernel else ssd_scan_mod.ssd_scan_plain
        y = scan(q, k, v_in.permute(0, 2, 1, 3), loga.permute(0, 2, 1), chunk=chunk)
        y, ssm_out = y.permute(0, 2, 1, 3), None
    else:
        k, q = (t[:, :, None].expand(B, T, H, N) for t in (Bc, Cc))
        y, ssm_out = ssm.ssd_chunked(q, k, v_in, loga, state=state["ssm"], chunk=chunk)
    y = y + v * p["D"][None, None, :, None].to(v.dtype)
    y = _gated_norm(y.reshape(B, T, d_in), z, p["norm_scale"])
    out = y @ p["w_out"]
    new_state = None
    if state is not None:
        conv_tail = torch.cat([state["conv"], xBC_pre], dim=1)[:, -(cfg.ssm_conv - 1):]
        new_state = {"ssm": ssm_out, "conv": conv_tail}
    return out, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: Optional[torch.dtype] = None,
                     device=None) -> Params:
    d_in, H, P, N, conv_ch = _dims(cfg)
    return {
        "ssm": torch.zeros(batch, H, N, P, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_ch, dtype=dtype or cfg.tdtype,
                            device=device),
    }


def mamba_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               state: Params) -> Tuple[torch.Tensor, Params]:
    """Single-token decode.  x (B, 1, d) -> (y (B, 1, d), new state)."""
    B = x.shape[0]
    d_in, H, P, N, conv_ch = _dims(cfg)
    h = x[:, 0] @ p["w_in"]
    z, xBC, dt = _split(cfg, h)
    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)  # (B, K, C)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xs, Bc, Cc = torch.split(F.silu(conv), [d_in, N, N], dim=-1)
    v = xs.reshape(B, H, P)
    k, q = (t[:, None, :].expand(B, H, N) for t in (Bc, Cc))
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    loga = -torch.exp(p["A_log"]) * dt
    v_in = v * dt[..., None].to(v.dtype)
    y, ssm_out = ssm.ssd_step(q, k, v_in, loga, state["ssm"])
    y = y + v * p["D"][None, :, None].to(v.dtype)
    y = _gated_norm(y.reshape(B, d_in), z, p["norm_scale"])
    out = (y @ p["w_out"])[:, None, :]
    return out, {"ssm": ssm_out, "conv": window[:, 1:]}

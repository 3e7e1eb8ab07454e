"""RWKV6 ("Finch") block: data-dependent per-channel decay linear attention.

The counterpart of ``repro.models.rwkv``, with its structure and its
simplification: token-shift lerp mixing for (r, k, v, w, g) with
independent learned coefficients ``mu``; a low-rank data-dependent decay
``w_t = exp(-exp(w0 + tanh(m_w @ Wa) @ Wb))``; the wkv recurrence with
the bonus ``u`` (:func:`repro_torch.models.ssm.gla_chunked`); a per-head
group norm; a silu-gated output; and a squared-ReLU channel mix with its
own token shift and receptance gate.

``w0`` and ``u`` are f32 in a model of any dtype, as in the reference.
A one-token call with a state (decode) takes :func:`ssm.gla_step`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import ssm
from repro_torch.models.common import ModelConfig, Params, dense_init

__all__ = ["init_rwkv_time_mix", "init_rwkv_channel_mix", "time_mix", "channel_mix",
           "init_rwkv_state"]


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads if cfg.n_heads > 0 else d // 64
    return d, H, d // H


def init_rwkv_time_mix(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, H, Dk = _dims(cfg)
    lora = max(32, d // 32)
    dt, dev = cfg.tdtype, gen.device
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),  # lerp coefs for r, k, v, w, g
        "wr": dense_init(gen, (d, d), dt),
        "wk": dense_init(gen, (d, d), dt),
        "wv": dense_init(gen, (d, d), dt),
        "wg": dense_init(gen, (d, d), dt),
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),  # base log-log decay
        "wa": dense_init(gen, (d, lora), dt),
        "wb": dense_init(gen, (lora, d), dt, scale=0.01),
        "u": torch.full((H, Dk), 0.5, dtype=torch.float32, device=dev),
        "gn_scale": torch.ones(d, dtype=dt, device=dev),
        "gn_bias": torch.zeros(d, dtype=dt, device=dev),
        "wo": dense_init(gen, (d, d), dt),
    }


def init_rwkv_channel_mix(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    return {
        "mu": torch.full((2, d), 0.5, dtype=cfg.tdtype, device=gen.device),  # for k, r
        "wk": dense_init(gen, (d, cfg.d_ff), cfg.tdtype),
        "wv": dense_init(gen, (cfg.d_ff, d), cfg.tdtype),
        "wr": dense_init(gen, (d, d), cfg.tdtype),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; position 0 gets ``last`` (or zeros)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _group_norm(x: torch.Tensor, H: int, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over (B, T, d) viewed as (B, T, H, Dk): f32
    statistics (population variance), the affine in x's dtype."""
    B, T, d = x.shape
    xf = x.reshape(B, T, H, d // H).float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, T, d)
    return y.to(x.dtype) * scale + bias


def time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
             state: Optional[Params] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, T, d); ``state`` {'shift': (B, d), 'wkv': (B, H, Dk, Dk)} when
    streaming.  Returns (out, new state or None); the new state's tensors
    are new, so the caller may copy them into the state it passed."""
    B, T, d = x.shape
    _, H, Dk = _dims(cfg)
    xx = _shift(x, None if state is None else state["shift"])
    mu = p["mu"]
    delta = xx - x
    mr, mk, mv, mw, mg = (x + delta * mu[i] for i in range(5))
    r = (mr @ p["wr"]).reshape(B, T, H, Dk)
    k = (mk @ p["wk"]).reshape(B, T, H, Dk)
    v = (mv @ p["wv"]).reshape(B, T, H, Dk)
    g = F.silu(mg @ p["wg"])
    # the data-dependent decay (RWKV6's signature), f32
    dd = torch.tanh(mw @ p["wa"]) @ p["wb"]
    logw = -torch.exp(torch.clamp(p["w0"] + dd.float(), -8.0, 2.0)).reshape(B, T, H, Dk)
    wkv_state = None if state is None else state["wkv"]
    if T == 1 and wkv_state is not None:  # decode fast path
        y, wkv_out = ssm.gla_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["u"], wkv_state)
        y = y[:, None]
    else:
        y, wkv_out = ssm.gla_chunked(r, k, v, logw, p["u"], state=wkv_state,
                                     chunk=min(cfg.ssm_chunk, T))
    y = _group_norm(y.reshape(B, T, d), H, p["gn_scale"], p["gn_bias"])
    out = (y * g) @ p["wo"]
    new_state = None if state is None else {"shift": x[:, -1], "wkv": wkv_out}
    return out, new_state


def channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Squared-ReLU channel mix; ``state`` (B, d) is the last token's x."""
    del cfg
    xx = _shift(x, state)
    delta = xx - x
    mk = x + delta * p["mu"][0]
    mr = x + delta * p["mu"][1]
    h = torch.square(F.relu(mk @ p["wk"]))
    out = torch.sigmoid(mr @ p["wr"]) * (h @ p["wv"])
    return out, (x[:, -1] if state is not None else None)


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> Params:
    d, H, Dk = _dims(cfg)
    return {
        "tm": {"shift": torch.zeros(batch, d, dtype=cfg.tdtype, device=device),
               "wkv": torch.zeros(batch, H, Dk, Dk, dtype=torch.float32, device=device)},
        "cm": torch.zeros(batch, d, dtype=cfg.tdtype, device=device),
    }

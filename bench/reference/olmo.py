"""Plain reference of the OLMo decoder (Groeneveld et al., arXiv:2402.00838),
in plain PyTorch.

Token embedding; each layer ``x += attn(LN(x))``, ``x += mlp(LN(x))``, a
final LN, and the output head tied to the embedding (logits ``x @ E^T``).
LN is non-parametric: mean and population variance over the model width,
no scale or bias.  Attention: q, k, v projections without bias, rotary
embeddings on the two halves of each head (``theta``), causal softmax
attention scaled by ``1/sqrt(head_dim)``, the output projection.  The MLP
is SwiGLU: ``(silu(x W_g) * (x W_u)) W_d``.  The loss is the mean softmax
cross-entropy of the next tokens.

The parameters come as a dict under the layout the benchmark makes them
in, the layers stacked on a leading axis: ``embed (V, d)``,
``layers.attn.wq/wk/wv (L, d, H, hd)``, ``layers.attn.wo (L, H, hd, d)``,
``layers.ffn.wg/wu (L, d, f)``, ``layers.ffn.wd (L, f, d)``.

``prec="f32"`` computes in float32 (TF32 left to the caller's switches,
which the harness turns off).  ``prec="fp8"``, the control's precision,
rounds both operands of every matrix product to float8 e4m3 with one
scale a tensor (its largest magnitude to 448), the gradient passing
straight through the rounding.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["loss", "forward", "make_loss"]

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _mm(prec: str):
    if prec == "f32":
        return lambda eq, a, b: torch.einsum(eq, a, b)
    if prec == "fp8":
        return lambda eq, a, b: torch.einsum(eq, _fp8(a), _fp8(b))
    raise ValueError(f"unknown precision {prec!r} for this reference")


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd): each head's halves rotated by position * freq."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs  # (T, half)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict,
            prec: str = "f32") -> torch.Tensor:
    mm = _mm(prec)
    eps, theta = float(cfg["layer_norm_eps"]), float(cfg["rope_theta"])
    E = params["embed"].float()
    x = F.embedding(tokens, E)
    B, T, _ = x.shape
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    # one unbind a stacked leaf: its gradient is written once, as one stack
    layer = {k: v.float().unbind(0) for k, v in params.items() if k.startswith("layers.")}
    for l in range(len(layer["layers.attn.wq"])):
        wq, wk, wv = (layer[f"layers.attn.{n}"][l] for n in ("wq", "wk", "wv"))
        wo = layer["layers.attn.wo"][l]
        h = _ln(x, eps)
        q = _rope(mm("btd,dhk->bthk", h, wq), theta)
        k = _rope(mm("btd,dhk->bthk", h, wk), theta)
        v = mm("btd,dhk->bthk", h, wv)
        s = mm("bthk,bshk->bhts", q, k) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~causal, float("-inf"))
        a = torch.softmax(s, dim=-1)
        o = mm("bhts,bshk->bthk", a, v)
        x = x + mm("bthk,hkd->btd", o, wo)
        h = _ln(x, eps)
        wg, wu, wd = (layer[f"layers.ffn.{n}"][l] for n in ("wg", "wu", "wd"))
        u = F.silu(mm("btd,df->btf", h, wg)) * mm("btd,df->btf", h, wu)
        x = x + mm("btf,fd->btd", u, wd)
    x = _ln(x, eps)
    return mm("btd,vd->btv", x, E)


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], cfg: dict,
         prec: str = "f32") -> torch.Tensor:
    logits = forward(params, batch["tokens"].long(), cfg, prec)
    labels = batch["labels"].long()
    return torch.mean(torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0])


def make_loss(model: dict):
    """``loss(params, batch, prec)`` for the configuration's ``model`` block."""
    return lambda params, batch, prec: loss(params, batch, model, prec)

"""Plain reference of the paper's CIFAR-10 model: a ResNet-20 with GroupNorm
(He et al., arXiv:1512.03385, Sec. 4.2, with each BatchNorm a GroupNorm of
8 groups, Wu and He, arXiv:1803.08494), in plain PyTorch.

Widths 16/32/64 over three stages of 3 basic blocks; the first block of
stages 2 and 3 halves the resolution with a stride-2 3x3 convolution and
a stride-2 1x1 projection on its shortcut; global average pooling and a
linear head.  The parameters come as a dict under the layout the
benchmark makes them in: convolution weights HWIO ``(k, k, cin, cout)``,
images NHWC.  Convolutions pad as XLA's ``"SAME"``: a stride-2 3x3 on an
even input pads (0, 1).  GroupNorm: ``min(8, C)`` groups, population
variance, eps 1e-5, then a per-channel scale and bias.

``prec="f32"`` computes in float32 (TF32 left to the caller's switches,
which the harness turns off); ``prec="bf16"`` casts the weights and the
activations to bfloat16 at every use, the control's precision.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["loss", "forward", "make_loss"]


def _dtype(prec: str) -> torch.dtype:
    if prec == "f32":
        return torch.float32
    if prec == "bf16":
        return torch.bfloat16
    raise ValueError(f"unknown precision {prec!r} for this reference")


def _pad(size: int, k: int, stride: int):
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int, dt) -> torch.Tensor:
    k = w_hwio.shape[0]
    top, bottom = _pad(x.shape[2], k, stride)
    left, right = _pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.to(dt).permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int, dt) -> torch.Tensor:
    B, C, H, W = x.shape
    g = min(groups, C)
    xg = x.reshape(B, g, C // g, H, W)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mu) / torch.sqrt(var + 1e-5)).reshape(B, C, H, W)
    return y * scale.to(dt).view(1, C, 1, 1) + bias.to(dt).view(1, C, 1, 1)


def forward(params: Dict[str, torch.Tensor], images: torch.Tensor, prec: str = "f32",
            groups: int = 8) -> torch.Tensor:
    dt = _dtype(prec)
    x = images.to(dt).permute(0, 3, 1, 2).contiguous()
    x = F.relu(_gn(_conv(x, params["stem.w"], 1, dt), params["stem.gn.scale"],
                   params["stem.gn.bias"], groups, dt))
    s = 0
    while f"stages.{s}.0.w1" in params:
        b = 0
        while f"stages.{s}.{b}.w1" in params:
            pre = f"stages.{s}.{b}."
            stride = 2 if (s > 0 and b == 0) else 1
            h = F.relu(_gn(_conv(x, params[pre + "w1"], stride, dt), params[pre + "gn1.scale"],
                           params[pre + "gn1.bias"], groups, dt))
            h = _gn(_conv(h, params[pre + "w2"], 1, dt), params[pre + "gn2.scale"],
                    params[pre + "gn2.bias"], groups, dt)
            sc = _conv(x, params[pre + "wproj"], stride, dt) if pre + "wproj" in params else x
            x = F.relu(h + sc)
            b += 1
        s += 1
    pooled = x.mean(dim=(2, 3))
    return pooled @ params["fc.w"].to(dt) + params["fc.b"].to(dt)


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         prec: str = "f32", groups: int = 8) -> torch.Tensor:
    """Mean softmax cross-entropy of the batch's labels, in f32."""
    logits = forward(params, batch["images"], prec, groups).float()
    labels = batch["labels"].long()
    return torch.mean(torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0])


def make_loss(model: dict):
    """``loss(params, batch, prec)`` for the configuration's ``model`` block."""
    return lambda params, batch, prec: loss(params, batch, prec, int(model["groups"]))

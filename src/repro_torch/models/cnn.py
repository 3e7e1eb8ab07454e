"""ResNet-20-style CNN with GroupNorm for the paper's CIFAR-10 experiment.

The PyTorch counterpart of ``repro.models.cnn``.  Its layouts are the
reference's: conv weights are stored HWIO ``(k, k, cin, cout)`` and
images come in NHWC; ``forward`` permutes to PyTorch's NCHW/OIHW inside.
Parameters sit under the reference's key paths (``stem.w``,
``stages.1.0.wproj``, ``fc.b``, ...), so the flattened ``(n, d)`` update
stack matches the reference column for column.

GroupNorm follows the reference exactly: ``min(groups, C)`` groups of
neighbouring channels, f32 statistics, population variance, eps 1e-5,
per-channel scale and bias after the normalisation.  Convolutions pad as
XLA's ``"SAME"`` does, which for a stride-2 3x3 conv on an even input is
(0, 1), not symmetric.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tree
from repro_torch.models.common import softmax_cross_entropy

__all__ = ["CNNConfig", "CNN", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet20"
    n_classes: int = 10
    widths: Tuple[int, int, int] = (16, 32, 64)
    blocks_per_stage: int = 3
    image_size: int = 32
    channels: int = 3
    groups: int = 8
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _conv_weight(k: int, cin: int, cout: int, dtype, gen) -> nn.Parameter:
    std = (2.0 / (k * k * cin)) ** 0.5
    w = torch.randn((k, k, cin, cout), generator=gen, dtype=torch.float32) * std
    return nn.Parameter(w.to(dtype))


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with an HWIO weight and XLA "SAME" padding."""
    k = w_hwio.shape[0]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


class _GroupNorm(nn.Module):
    def __init__(self, c: int, groups: int, dtype):
        super().__init__()
        self.groups = min(groups, c)
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        B, C, H, W = x.shape
        xf = x.reshape(B, self.groups, C // self.groups, H, W).float()
        mu = xf.mean(dim=(2, 3, 4), keepdim=True)
        var = xf.var(dim=(2, 3, 4), keepdim=True, correction=0)
        y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
        return y.to(x.dtype) * self.scale.view(1, C, 1, 1) + self.bias.view(1, C, 1, 1)


class _Stem(nn.Module):
    def __init__(self, cfg: CNNConfig, gen):
        super().__init__()
        self.w = _conv_weight(3, cfg.channels, cfg.widths[0], cfg.tdtype, gen)
        self.gn = _GroupNorm(cfg.widths[0], cfg.groups, cfg.tdtype)

    def forward(self, x):
        return F.relu(self.gn(_conv(x, self.w)))


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, cfg: CNNConfig, gen):
        super().__init__()
        self.stride = stride
        self.w1 = _conv_weight(3, cin, cout, cfg.tdtype, gen)
        self.gn1 = _GroupNorm(cout, cfg.groups, cfg.tdtype)
        self.w2 = _conv_weight(3, cout, cout, cfg.tdtype, gen)
        self.gn2 = _GroupNorm(cout, cfg.groups, cfg.tdtype)
        self.wproj = (_conv_weight(1, cin, cout, cfg.tdtype, gen)
                      if stride != 1 or cin != cout else None)

    def forward(self, x):
        h = F.relu(self.gn1(_conv(x, self.w1, self.stride)))
        h = self.gn2(_conv(h, self.w2))
        sc = _conv(x, self.wproj, self.stride) if self.wproj is not None else x
        return F.relu(h + sc)


class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int, dtype, gen):
        super().__init__()
        w = torch.randn((cin, cout), generator=gen, dtype=torch.float32) * 0.01
        self.w = nn.Parameter(w.to(dtype))
        self.b = nn.Parameter(torch.zeros(cout, dtype=dtype))

    def forward(self, x):
        return x @ self.w + self.b


class CNN(nn.Module):
    """images (B, H, W, C) -> logits (B, n_classes).  Initialised from
    ``generator`` (a CPU :class:`torch.Generator`); move it with ``.to``."""

    def __init__(self, cfg: CNNConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.stem = _Stem(cfg, generator)
        stages, cin = [], cfg.widths[0]
        for s, cout in enumerate(cfg.widths):
            blocks = []
            for b in range(cfg.blocks_per_stage):
                blocks.append(_Block(cin, cout, 2 if (s > 0 and b == 0) else 1, cfg, generator))
                cin = cout
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.fc = _Linear(cin, cfg.n_classes, cfg.tdtype, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC -> contiguous NCHW: channels-last activations hit a fault in
        # the backward of oneDNN's strided 1x1 conv on multi-threaded CPUs
        x = self.stem(images.to(self.cfg.tdtype).permute(0, 3, 1, 2).contiguous())
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
        return self.fc(x.mean(dim=(2, 3)))

    def param_tree(self):
        """The parameters as a detached tree under the reference's key paths."""
        return tree.from_paths({k: p.detach().clone() for k, p in self.named_parameters()})


def loss_fn(model: CNN, params, batch: dict):
    """Mean CE of ``model`` run with the parameter tree ``params``; returns
    ``(loss, {"ce": loss, "acc": acc})`` as the reference does."""
    named = dict(zip(tree.paths(params), tree.leaves(params)))
    logits = torch.func.functional_call(model, named, (batch["images"],))
    loss = torch.mean(softmax_cross_entropy(logits, batch["labels"]))
    acc = torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())
    return loss, {"ce": loss, "acc": acc}

"""The paper's ResNet-20 with GroupNorm: its weights and client shards as the
benchmark makes them from the seed, the port's model that the trainer
runs, and the arithmetic of its operations.

Weights (made on the run's device by one generator, in one draw): He
normal for every convolution (std ``sqrt(2 / (k^2 cin))``), ``N(0, 0.01^2)``
for the head's weights, GroupNorm scale 1 and bias 0, head bias 0, all
f32.  Data: CIFAR-10-shaped images, each its class's smooth template
(a random 4x4x3 field, upsampled) plus ``noise`` times Gaussian noise,
labels uniform; split over the clients by sort-and-partition.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchlib.data import sort_and_partition

__all__ = ["param_shapes", "n_params", "make_params", "make_shards", "program", "macs_per_image",
           "flops_per_round", "comparison_leaves"]


def _blocks(model: dict):
    """``(stage, block, cin, cout, stride)`` of every residual block."""
    cin = model["widths"][0]
    for s, cout in enumerate(model["widths"]):
        for b in range(model["blocks_per_stage"]):
            yield s, b, cin, cout, (2 if (s > 0 and b == 0) else 1)
            cin = cout


def param_shapes(model: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter's path and shape, convolutions HWIO."""
    w0, c = model["widths"][0], model["channels"]
    out = [("stem.w", (3, 3, c, w0)), ("stem.gn.scale", (w0,)), ("stem.gn.bias", (w0,))]
    for s, b, cin, cout, stride in _blocks(model):
        pre = f"stages.{s}.{b}."
        out += [(pre + "w1", (3, 3, cin, cout)), (pre + "gn1.scale", (cout,)),
                (pre + "gn1.bias", (cout,)), (pre + "w2", (3, 3, cout, cout)),
                (pre + "gn2.scale", (cout,)), (pre + "gn2.bias", (cout,))]
        if stride != 1 or cin != cout:
            out.append((pre + "wproj", (1, 1, cin, cout)))
    out += [("fc.w", (model["widths"][-1], model["n_classes"])), ("fc.b", (model["n_classes"],))]
    return out


def n_params(config: dict) -> int:
    model = config["model"]
    return int(sum(np.prod(s) for _, s in param_shapes(model)))


def make_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(config["model"])
    drawn = [(k, s) for k, s in shapes if k.endswith(("w", "w1", "w2", "wproj"))]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(int(np.prod(s)) for _, s in drawn), generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes:
        if (k, s) in drawn:
            size = int(np.prod(s))
            std = 0.01 if k == "fc.w" else (2.0 / (s[0] * s[1] * s[2])) ** 0.5
            out[k] = (z[at:at + size] * std).reshape(s)
            at += size
        else:
            out[k] = (torch.ones if k.endswith("scale") else torch.zeros)(
                s, dtype=torch.float32, device=device)
    return out


def make_shards(config: dict, traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """Every client's images (N_i, H, W, C) f32 and labels (N_i,) int32."""
    model, protocol, data = config["model"], config["protocol"], config["data"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    C, H, ch = model["n_classes"], model["image_size"], model["channels"]
    N = int(data["images"])
    base = torch.randn((C, 4, 4, ch), generator=gen, device=device)
    templates = base.repeat_interleave(H // 4, 1).repeat_interleave(H // 4, 2)
    labels = torch.randint(0, C, (N,), generator=gen, device=device)
    images = templates[labels] + float(data["noise"]) * torch.randn(
        (N, H, H, ch), generator=gen, device=device)
    images, labels = images.cpu().numpy(), labels.to(torch.int32).cpu().numpy()
    parts = sort_and_partition(labels, protocol["n_clients"], int(data["non_iid_s"]),
                               np.random.default_rng([int(seed), 0x5a7]))
    return [{"images": images[idx], "labels": labels[idx]} for idx in parts]


def program(config: dict, device):
    """The port's model: ``(loss_fn(params, batch), tree_of(flat))``, where
    ``tree_of`` lays a flat dict of parameters out as the port's tree."""
    from repro_torch import tree
    from repro_torch.models import build
    from repro_torch.models.cnn import CNN, CNNConfig

    model = config["model"]
    cfg = CNNConfig(name="resnet20", n_classes=model["n_classes"],
                    widths=tuple(model["widths"]), blocks_per_stage=model["blocks_per_stage"],
                    image_size=model["image_size"], channels=model["channels"],
                    groups=model["groups"], dtype="float32")
    got = {k: tuple(p.shape) for k, p in CNN(cfg).named_parameters()}
    if got != dict(param_shapes(model)):
        raise RuntimeError(f"the port's ResNet lays its parameters out otherwise: {got}")
    bundle = build(cfg)
    return bundle.loss_fn, tree.from_paths


def macs_per_image(model: dict) -> int:
    """Multiply-adds of one forward pass of one image: every convolution at
    its output resolution, and the head."""
    res, c, w0 = model["image_size"], model["channels"], model["widths"][0]
    macs = res * res * w0 * 9 * c
    for _, _, cin, cout, stride in _blocks(model):
        res //= stride
        macs += res * res * cout * 9 * cin + res * res * cout * 9 * cout
        if stride != 1 or cin != cout:
            macs += res * res * cout * cin
    return int(macs + model["widths"][-1] * model["n_classes"])


def flops_per_round(config: dict, traffic: dict) -> float:
    """Training FLOPs of one round: 2 a multiply-add, forward and twice
    that backward, over every image of every client's T steps."""
    protocol = config["protocol"]
    images = protocol["batch_size"] * protocol["local_steps"] * protocol["n_clients"]
    return 6.0 * macs_per_image(config["model"]) * images


def comparison_leaves(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves the comparison holds apart: every parameter."""
    return dict(flat)

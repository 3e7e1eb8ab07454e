"""Sparsifying wire formats: ``topk`` (deterministic) and ``randk``.

``topk`` ships each client's ``k`` largest-magnitude coordinates and zeros
the rest — the classic gradient-sparsification format.  It is biased
(``E[decode] != x``: the dropped tail is lost), but the error concentrates
in the smallest coordinates.  The descriptor declares ``unbiased=False``
and no ``gain``: there is no data-independent correction.

``randk`` keeps ``k`` uniformly random coordinates per client row.  Each
coordinate survives with probability ``k/d``, so
``E[decode(encode(x))] = (k/d) · x`` — a known multiplicative bias the
descriptor exposes as ``gain = k/d``, which the consuming strategy
divides out, restoring ``E = x`` at a variance of ``(d/k - 1)`` per unit
of coordinate energy.

Both keep a dense masked ``(n, d)`` representation; ``bits_per_coord``
accounts for the index + value wire cost.  ``k`` is resolved from
``fraction`` against ``d``.

The port of ``repro.wire.topk``: the descriptors are the reference's.
``topk``'s mask is ``torch.topk`` of ``|x|``, the reference's support on
data without ties.  ``randk`` ranks uniforms drawn from a
``torch.Generator`` held as codec state on the stack's device (the int8
codec's pattern, so a captured round registers it and replays advance
one stream); the reference draws from ``jax.random``, so the two agree in
law, not draw for draw.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.wire import registry
from repro_torch.wire.base import CodecDescriptor, State, WireCodec

__all__ = ["TopKCodec", "RandKCodec"]


def _resolve_k(d: int, k: Optional[int], fraction: float) -> int:
    kk = int(k) if k is not None else int(round(fraction * d))
    return max(1, min(kk, d))


def _sparse_bits(k: int, d: int) -> float:
    """k (value, index) pairs on the wire: a 32-bit value and a log2(d)
    index each, per coordinate of the row."""
    return k * (32.0 + math.log2(max(d, 2))) / max(d, 1)


def _keep(xf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``xf`` with every coordinate but the ``(n, k)`` indices ``idx`` of
    its row zeroed."""
    mask = torch.zeros_like(xf).scatter_(1, idx, 1.0)
    return xf * mask


class _SparseCodec(WireCodec):
    def __init__(self, fraction: float = 0.1, k: Optional[int] = None):
        if k is None and not 0.0 < float(fraction) <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self.k = None if k is None else int(k)

    def _k(self, d: int) -> int:
        return _resolve_k(d, self.k, self.fraction)

    def decode(self, encoded: torch.Tensor) -> torch.Tensor:
        return encoded


class TopKCodec(_SparseCodec):
    """Keep the ``k`` largest-|x| coordinates per client row."""

    name = "topk"

    def descriptor(self, d: int) -> CodecDescriptor:
        return CodecDescriptor(name=self.name, bits_per_coord=_sparse_bits(self._k(d), d),
                               unbiased=False, gain=1.0, rel_variance=0.0)

    def encode(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        xf = x.float()
        _, idx = torch.topk(torch.abs(xf), self._k(xf.shape[1]), dim=1)
        return _keep(xf, idx), state


class RandKCodec(_SparseCodec):
    """Keep ``k`` uniformly random coordinates per client row; unbiased
    after the strategy divides by ``gain = k/d``."""

    name = "randk"
    stateful = True

    def __init__(self, fraction: float = 0.1, k: Optional[int] = None, seed: int = 0):
        super().__init__(fraction, k)
        self.seed = int(seed)

    def descriptor(self, d: int) -> CodecDescriptor:
        k = self._k(d)
        return CodecDescriptor(name=self.name, bits_per_coord=_sparse_bits(k, d),
                               unbiased=True,  # after dividing by gain
                               gain=k / d, rel_variance=d / k - 1.0)

    def init_state(self, n: int, d: int, *, device=None) -> torch.Generator:
        del n, d
        return torch.Generator(device=device or "cpu").manual_seed(self.seed)

    def encode(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        xf = x.float()
        # an independent uniform k-subset per row: the k smallest of i.i.d.
        # uniforms, exact sampling without replacement
        u = torch.rand(xf.shape, generator=state, device=xf.device, dtype=torch.float32)
        _, idx = torch.topk(-u, self._k(xf.shape[1]), dim=1)
        return _keep(xf, idx), state


registry.register("topk", TopKCodec)
registry.register("randk", RandKCodec)

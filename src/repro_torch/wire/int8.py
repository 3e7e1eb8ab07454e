"""Integer quantization with stochastic rounding (the ``int8`` codec), and
the no-op ``identity`` codec.

Per-client affine quantization of the flattened update row: client
``i``'s row is scaled by ``s_i = max_j |x_ij| / L`` (``L = 2^(b-1) - 1``
levels for ``b`` bits, ``s_i`` floored at 1e-12) and rounded
*stochastically* —

    q = floor(x / s + u),   u ~ U[0, 1)  i.i.d. per coordinate

so ``E[q · s] = x``: the wire format is unbiased by construction and the
aggregation needs no correction (``descriptor().gain == 1``).  The price
is quantization noise of variance ``s² · f(1-f) <= s²/4`` per coordinate.

The encoded form is ``(q int8 (n, d), s f32 (n, 1))`` — the affine shape
the fused dequant kernel (:mod:`repro_torch.kernels.fused_dequant`)
consumes by folding ``s`` into the aggregation weights, streaming the
int8 stack at a quarter of the f32 traffic.

Randomness is codec state: a ``(seed, step)`` pair of Python ints threaded
through the round's ``agg_state``.  Each encode seeds a ``torch.Generator``
on the stack's device from it and advances ``step`` by one, so every round
draws fresh noise, the same state gives the same draws, and no global RNG
is read.  The reference draws from ``jax.random`` keys, whose stream
cannot be reproduced here: the two agree in law (unbiasedness, grid
pitch), not draw for draw.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.wire import registry
from repro_torch.wire.base import CodecDescriptor, State, WireCodec

__all__ = ["IdentityCodec", "Int8StochasticCodec"]

_SCALE_FLOOR = 1e-12


class IdentityCodec(WireCodec):
    """The no-op wire format (infinite bits): decode(encode(x)) is x, so
    ``quantized(inner, codec="identity")`` is bitwise the inner strategy."""

    name = "identity"

    def descriptor(self, d: int) -> CodecDescriptor:
        return CodecDescriptor(name=self.name, bits_per_coord=32.0, unbiased=True)

    def encode(self, x: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        return x.float(), state

    def decode(self, encoded: torch.Tensor) -> torch.Tensor:
        return encoded


class Int8StochasticCodec(WireCodec):
    """``b``-bit symmetric quantization with stochastic rounding; ``bits``
    <= 8, the container is int8 regardless (the wire cost is ``bits`` per
    coordinate plus the row's f32 scale)."""

    name = "int8"
    stateful = True
    supports_fused_dequant = True
    supports_segmented = True

    def __init__(self, bits: int = 8, seed: int = 0):
        if not 2 <= int(bits) <= 8:
            raise ValueError(f"bits must be in [2, 8], got {bits}")
        self.bits = int(bits)
        self.seed = int(seed)
        #: symmetric levels: q in [-L, L]
        self.levels = 2 ** (self.bits - 1) - 1

    def descriptor(self, d: int) -> CodecDescriptor:
        return CodecDescriptor(
            name=self.name,
            # + the one f32 scale amortized over the row
            bits_per_coord=self.bits + 32.0 / max(d, 1),
            unbiased=True,
            gain=1.0,
            rel_variance=1.0 / (4.0 * self.levels**2),
        )

    def init_state(self, n: int, d: int) -> Tuple[int, int]:
        del n, d
        return (self.seed, 0)

    @staticmethod
    def _generator(state: Tuple[int, int], device) -> torch.Generator:
        seed, step = state
        mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(mixed))

    def _scale(self, rowmax: torch.Tensor) -> torch.Tensor:
        return torch.clamp(rowmax / self.levels, min=_SCALE_FLOOR)

    def _round(self, xf: torch.Tensor, scale: torch.Tensor, gen: torch.Generator):
        u = torch.rand(xf.shape, generator=gen, device=xf.device, dtype=torch.float32)
        q = torch.floor(xf / scale + u)
        return torch.clamp(q, -self.levels, self.levels).to(torch.int8)

    def encode(self, x: torch.Tensor, state: State) -> Tuple[tuple, State]:
        seed, step = state
        xf = x.float()
        scale = self._scale(torch.amax(torch.abs(xf), dim=1, keepdim=True))
        q = self._round(xf, scale, self._generator(state, xf.device))
        return (q, scale), (seed, step + 1)

    def encode_segments(self, segments, state: State) -> Tuple[tuple, State]:
        """Quantize per-leaf ``(n, d_i)`` segments against one row-global
        scale without assembling the stack.  The row scale is the max over
        per-segment row maxima — max is exact, so the scale is bitwise the
        monolithic :meth:`encode` scale.  The rounding noise is drawn
        segment by segment from the same generator: distributionally
        identical to :meth:`encode`'s, not the same realization; the state
        advances by the same single step."""
        seed, step = state
        xs = [s.float() for s in segments]
        rowmax = torch.amax(torch.abs(xs[0]), dim=1, keepdim=True)
        for xf in xs[1:]:
            rowmax = torch.maximum(rowmax, torch.amax(torch.abs(xf), dim=1, keepdim=True))
        scale = self._scale(rowmax)
        gen = self._generator(state, xs[0].device)
        return ([self._round(xf, scale, gen) for xf in xs], scale), (seed, step + 1)

    def decode(self, encoded: tuple) -> torch.Tensor:
        q, scale = encoded
        return q.float() * scale


registry.register("identity", IdentityCodec)
registry.register("int8", Int8StochasticCodec)

"""Quantized relaying: any inner strategy behind a wire-format codec (the
port of ``repro.strategies.quantized``).

The paper's scheme doubles each client's uplink traffic (its own update
plus relayed neighbours'); ``quantized`` compresses the dense ``(n, d)``
update stack to a wire format before the relay mix.  It wraps an inner
:class:`~repro_torch.strategies.base.AggregationStrategy` (``colrel`` by
default) and a :class:`~repro_torch.wire.WireCodec` from the codec
registry::

    strategies.get("quantized")                                # int8(colrel)
    strategies.get("quantized", codec="int8", codec_options={"bits": 4})

**Unbiasedness-correction hook.**  The codec's descriptor declares any
known multiplicative bias (``E[decode(encode(x))] = gain · x``); the
strategy divides the decoded stack by it before the inner aggregation.

**State.**  The strategy threads ``(codec_state, inner_state)`` through
the round's ``agg_state``; the int8 codec's state is a ``(seed, step)``
pair, so every round draws fresh rounding noise.

**Execution.**  ``fused=False`` (default) is the dequant oracle: ravel
once, ``decode`` to an f32 stack, inner ``aggregate``.  ``fused="kernel"``
streams the int8 affine wire form through
:func:`repro_torch.kernels.ops.fused_dequant_aggregate` with the scales
folded into the collapsed colrel weight row, so no f32 stack exists;
with ``ctx.use_segments(d)`` each leaf is quantized against one
row-global scale and its int8 segment goes through
:func:`repro_torch.kernels.ops.dequant_row_stream`.  Both ``fused=False``
and the monolithic kernel path encode the same raveled stack from the
same state, so they draw the same noise; the segment path draws another
realization of the same law.
"""

from __future__ import annotations

import torch

from repro_torch import tree, wire
from repro_torch.core import flatten
from repro_torch.kernels import ops as kernel_ops
from repro_torch.strategies import registry
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext, State

__all__ = ["QuantizedStrategy"]

_FUSED_MODES = (False, "kernel")


class QuantizedStrategy(AggregationStrategy):
    """Codec-compressed wire format around an inner aggregation scheme."""

    name = "quantized"
    scalar_collapsible = False  # quantization happens on the dense stack

    def __init__(self, codec="int8", inner="colrel", fused: "bool | str" = False,
                 codec_options=None, inner_options=None):
        self.codec = wire.resolve(codec, **dict(codec_options or {}))
        self.inner = registry.resolve(inner, **dict(inner_options or {}))
        if isinstance(self.inner, QuantizedStrategy):
            raise ValueError("quantized strategies do not nest")
        if fused not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES}, got {fused!r}")
        if fused == "kernel":
            if not self.codec.supports_fused_dequant:
                raise ValueError(
                    f"codec {self.codec.name!r} has no int8 affine form; "
                    "the fused dequant kernel needs supports_fused_dequant")
            if self.inner.name != "colrel":
                raise ValueError(
                    "the fused dequant kernel computes the colrel collapse; "
                    f"inner strategy {self.inner.name!r} cannot use it")
        self.fused = fused
        # proxy the inner scheme's connectivity contract
        self.needs_A = self.inner.needs_A

    def init_state(self, n: int, d: int, *, device=None) -> State:
        return (self.codec.init_state(n, d), self.inner.init_state(n, d, device=device))

    def wire_bits_per_coord(self, d: int) -> float:
        return self.codec.descriptor(d).bits_per_coord

    def _gain(self, d: int) -> float:
        return float(self.codec.descriptor(d).gain)

    def _debias(self, decoded: torch.Tensor, d: int) -> torch.Tensor:
        """The unbiasedness-correction hook: divide out the codec's
        declared multiplicative gain."""
        gain = self._gain(d)
        return decoded / gain if gain != 1.0 else decoded

    def aggregate(self, updates, tau_up, tau_dd, A, state: State):
        codec_state, inner_state = state
        encoded, codec_state = self.codec.encode(updates.float(), codec_state)
        decoded = self._debias(self.codec.decode(encoded), updates.shape[-1])
        delta, inner_state = self.inner.aggregate(decoded, tau_up, tau_dd, A, inner_state)
        return delta, (codec_state, inner_state)

    def aggregate_tree(self, deltas, tau_up, tau_dd, A, state, ctx: ExecutionContext):
        if self.fused != "kernel":
            return super().aggregate_tree(deltas, tau_up, tau_dd, A, state, ctx)
        spec = flatten.flat_spec(deltas, stacked=True)
        codec_state, inner_state = state
        if ctx.use_segments(spec.d) and self.codec.supports_segmented:
            # quantize per-leaf segments against one row-global scale, fold
            # the scales (and the gain) into the weight row once, and stream
            # each int8 segment: neither the f32 nor the int8 stack exists
            (qs, scale), codec_state = self.codec.encode_segments(
                flatten.ravel_stacked_segments(deltas, dtype=torch.float32), codec_state)
            w = kernel_ops.collapsed_weight_row(A, tau_up, tau_dd)
            ws = kernel_ops.fold_dequant_scales(w, scale / self._gain(spec.d))
            leaves = [kernel_ops.dequant_row_stream(ws, q, block_d=ctx.fused_block_d).reshape(shape)
                      for q, shape in zip(qs, spec.shapes)]
            return tree.unflatten(spec.treedef, leaves), (codec_state, inner_state)
        # flatten once, encode, and stream the int8 payload through one pass
        # with the scales (and the gain) folded into the collapsed row
        stack = flatten.ravel_stacked(deltas, dtype=torch.float32)
        (q, scale), codec_state = self.codec.encode(stack, codec_state)
        gflat = kernel_ops.fused_dequant_aggregate(A, tau_up, tau_dd, q,
                                                   scale / self._gain(spec.d),
                                                   block_d=ctx.fused_block_d)
        return (flatten.unravel(spec, gflat, dtype=torch.float32),
                (codec_state, inner_state))

    def __repr__(self) -> str:
        return (f"QuantizedStrategy(codec={self.codec.name!r}, "
                f"inner={self.inner.name!r}, fused={self.fused!r})")


registry.register("quantized", QuantizedStrategy)

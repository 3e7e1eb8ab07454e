"""The wire-format codec protocol (the reference's ``repro.wire.base``).

Collaborative relaying doubles each client's uplink traffic — its own
update plus its neighbours' relayed consensus — so the wire format of the
``(n, d)`` update stack is the binding cost of peer-aided FL over
intermittent links.  A :class:`WireCodec` is the compression half: an
``encode``/``decode`` pair over the dense update stack in plain PyTorch,
plus a :class:`CodecDescriptor` that tells the strategy layer how the
codec perturbs the aggregation — whether the reconstruction is unbiased,
the known multiplicative gain to divide out, and a per-coordinate noise
proxy.

Codec state is explicit and checkpointable: a stochastic codec carries a
plain value (the int8 codec a ``(seed, step)`` pair) that the strategy
threads through the round's ``agg_state``; each encode derives its
``torch.Generator`` from it, so no global RNG is read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

__all__ = ["CodecDescriptor", "WireCodec"]

State = Any
Encoded = Any


@dataclasses.dataclass(frozen=True)
class CodecDescriptor:
    """How a codec perturbs the aggregation — the strategy-facing contract.

    Attributes:
        name: registry key of the codec that produced this descriptor.
        bits_per_coord: average wire cost per coordinate of the encoded
            update (per-row side information such as scales amortized in).
        unbiased: True when ``E[decode(encode(x))] == x`` exactly (over
            the codec's own randomness), *after* dividing by ``gain``.
        gain: known multiplicative bias — ``E[decode(encode(x))] ==
            gain * x``; the consuming strategy divides the decoded stack
            by it (1.0 = no correction).
        rel_variance: per-coordinate reconstruction-noise proxy in units
            of the per-client row scale squared (int8: ``1/(4·L²)`` for
            ``L`` quantization levels); 0.0 means "not modeled".
    """

    name: str
    bits_per_coord: float
    unbiased: bool
    gain: float = 1.0
    rel_variance: float = 0.0


class WireCodec:
    """Base class / protocol for update-stack wire formats; everything
    operates on the dense flattened ``(n, d)`` update stack."""

    #: registry key; set by subclasses
    name: str = "base"
    #: whether the codec carries state across rounds
    stateful: bool = False
    #: True when ``encode`` returns ``(q int8 (n, d), scale f32 (n, 1))`` —
    #: the affine form the fused dequant kernel consumes without ever
    #: materializing the dequantized f32 stack.
    supports_fused_dequant: bool = False
    #: True when :meth:`encode_segments` is implemented: per-leaf
    #: ``(n, d_i)`` segments quantized against one row-global scale.
    supports_segmented: bool = False

    def descriptor(self, d: int) -> CodecDescriptor:
        """The bias/variance contract for flat dimension ``d``."""
        raise NotImplementedError

    def init_state(self, n: int, d: int) -> State:
        """Initial codec state for ``n`` clients and flat dim ``d``
        (``()`` for deterministic codecs)."""
        del n, d
        return ()

    def encode(self, x: torch.Tensor, state: State) -> Tuple[Encoded, State]:
        """Dense ``(n, d)`` f32 stack -> (encoded, next state)."""
        raise NotImplementedError

    def encode_segments(self, segments, state: State) -> Tuple[Encoded, State]:
        """Per-leaf ``[(n, d_i), ...]`` column segments -> ((encoded segment
        list, row scale), next state) without assembling the stack; the
        row scale is global across segments."""
        raise NotImplementedError(f"{type(self).__name__} does not support segmented encode")

    def decode(self, encoded: Encoded) -> torch.Tensor:
        """Encoded form -> reconstructed ``(n, d)`` f32 stack (raw — the
        strategy divides by ``descriptor().gain``)."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"

"""Wire-format codecs for quantized relaying (the reference's
``repro.wire``).  One protocol — :class:`WireCodec` (``encode``/``decode``
+ :class:`CodecDescriptor`) — and a string-keyed registry::

    from repro_torch import wire

    wire.available()                 # ('identity', 'int8')
    codec = wire.get("int8", bits=4)
    enc, state = codec.encode(stack, codec.init_state(n, d))
    recon = codec.decode(enc)

Built-in codecs: ``identity`` (the no-op format; ``quantized(colrel,
codec="identity")`` is bitwise colrel) and ``int8`` (symmetric
``bits``-level quantization with stochastic rounding, per-client scales,
and the affine ``(int8, scale)`` form the fused dequant kernel streams).
``topk`` and ``randk`` raise ``NotImplementedError`` naming their
ROADMAP.md item.  The consuming strategy is
``strategies.get("quantized", codec=...)``.
"""

from repro_torch.wire.base import CodecDescriptor, WireCodec
from repro_torch.wire.registry import available, get, register, resolve
from repro_torch.wire.int8 import IdentityCodec, Int8StochasticCodec

__all__ = [
    "CodecDescriptor",
    "WireCodec",
    "available",
    "get",
    "register",
    "resolve",
    "IdentityCodec",
    "Int8StochasticCodec",
]

"""``torch.Generator`` (de)serialization for checkpointable state.

The port's counterpart of ``repro.ckpt.keys``, which exchanges typed jax
PRNG keys for a tagged dict.  The port carries ``torch.Generator`` objects
instead (the int8, topk and randk codecs' states, the ``no_trace``
sampler's), which no serializer writes: :func:`encode_generator` exchanges
one for a tagged dict of its device and its ``get_state()`` bytes, and
:func:`decode_generator` either writes that state into an existing
generator (``into``) or builds one on the saved device.  Writing into the
existing object keeps its identity, which a captured chunked round
registered and keys its graph on.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["encode_generator", "decode_generator", "is_encoded_generator",
           "encode_generators", "decode_generators"]

_TAG = "__torch_generator__"


def encode_generator(gen: Any) -> Any:
    """A ``torch.Generator`` -> tagged dict; anything else passes through."""
    if isinstance(gen, torch.Generator):
        return {_TAG: str(gen.device), "state": gen.get_state()}
    return gen


def is_encoded_generator(obj: Any) -> bool:
    return isinstance(obj, dict) and _TAG in obj


def decode_generator(obj: Any, into: Optional[torch.Generator] = None,
                     device=None) -> torch.Generator:
    """Inverse of :func:`encode_generator`: the state set into ``into`` when
    given (and returned), else into a new generator on ``device`` (default:
    the saved device)."""
    if into is None:
        into = torch.Generator(device=device if device is not None else obj[_TAG])
    into.set_state(obj["state"])
    return into


def encode_generators(tree: Any) -> Any:
    """``tree`` with every generator encoded (containers rebuilt)."""
    if isinstance(tree, dict):
        return {k: encode_generators(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [encode_generators(v) for v in tree]
        return t if isinstance(tree, list) else tuple(t)
    return encode_generator(tree)


def decode_generators(saved: Any, like: Any = None, device=None) -> Any:
    """Inverse of :func:`encode_generators`, with the other leaves as
    tensors on ``device``.  Each encoded generator is written into the
    generator at the same place of ``like`` where there is one."""
    if is_encoded_generator(saved):
        into = like if isinstance(like, torch.Generator) else None
        return decode_generator(saved, into=into, device=device)
    if isinstance(saved, dict):
        like = like if isinstance(like, dict) else {}
        return {k: decode_generators(v, like.get(k), device) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        likes = list(like) if isinstance(like, (list, tuple)) else []
        likes += [None] * (len(saved) - len(likes))
        t = [decode_generators(v, lk, device) for v, lk in zip(saved, likes)]
        return t if isinstance(saved, list) else tuple(t)
    return torch.as_tensor(saved, device=device)

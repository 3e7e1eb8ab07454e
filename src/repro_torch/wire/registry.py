"""String-keyed codec registry, mirroring ``strategies/registry.py``.

``get("int8", bits=4)`` instantiates a registered factory; ``register``
opens the family to new wire formats; ``resolve`` turns a name or an
already-built :class:`~repro_torch.wire.base.WireCodec` into an instance.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.wire.base import WireCodec

__all__ = ["register", "get", "available", "resolve"]

_FACTORIES: Dict[str, Callable[..., WireCodec]] = {}


def register(name: str, factory: Optional[Callable[..., WireCodec]] = None, *,
             overwrite: bool = False):
    """Register a codec factory (class or callable) under ``name``; usable
    directly or as a class decorator."""

    def _do(f: Callable[..., WireCodec]):
        if not overwrite and name in _FACTORIES:
            raise ValueError(f"codec {name!r} already registered")
        _FACTORIES[name] = f
        return f

    return _do if factory is None else _do(factory)


def available() -> Tuple[str, ...]:
    """Registered codec names, sorted."""
    return tuple(sorted(_FACTORIES))


def get(name: str, **options) -> WireCodec:
    """Instantiate a registered codec by name."""
    try:
        factory = _FACTORIES[str(name)]
    except KeyError:
        raise KeyError(f"unknown wire codec {name!r}; have {available()}") from None
    codec = factory(**options)
    if not isinstance(codec, WireCodec):
        raise TypeError(f"factory for {name!r} returned {type(codec).__name__}, not a WireCodec")
    return codec


def resolve(spec, **options) -> WireCodec:
    """A :class:`WireCodec` instance (returned as is) or a registry name ->
    an instance."""
    if isinstance(spec, WireCodec):
        if options:
            raise ValueError(f"cannot apply options {sorted(options)} to an "
                             "already-constructed codec instance")
        return spec
    return get(spec, **options)

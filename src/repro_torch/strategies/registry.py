"""String-keyed strategy registry.

``get("colrel", fused="kernel")`` instantiates a registered factory;
``register`` opens the family to new schemes; ``resolve`` turns a name or
an already-built instance into an instance.  The reference's strategies
that this package does not have yet raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.strategies.base import AggregationStrategy

__all__ = ["register", "get", "available", "resolve"]

_FACTORIES: Dict[str, Callable[..., AggregationStrategy]] = {}

# the reference's strategies still to port -> the ROADMAP.md item bringing them
_UNPORTED = {
    "colrel_fused": "queue 1, item 6 (deprecated alias; use 'colrel' with fused='collapse')",
}


def register(name: str, factory: Optional[Callable[..., AggregationStrategy]] = None):
    """Register a strategy factory (class or callable) under ``name``;
    usable directly or as a class decorator."""

    def _do(f: Callable[..., AggregationStrategy]):
        if name in _FACTORIES:
            raise ValueError(f"strategy {name!r} already registered")
        _FACTORIES[name] = f
        return f

    return _do if factory is None else _do(factory)


def available() -> Tuple[str, ...]:
    """Registered strategy names."""
    return tuple(sorted(_FACTORIES))


def get(name: str, **options) -> AggregationStrategy:
    """Instantiate a registered strategy by name."""
    if name in _UNPORTED:
        raise NotImplementedError(
            f"strategy {name!r} is not ported to repro_torch yet: ROADMAP.md {_UNPORTED[name]}")
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise KeyError(f"unknown aggregation strategy {name!r}; have {available()}") from None
    return factory(**options)


def resolve(spec, **options) -> AggregationStrategy:
    """A registry name or a constructed strategy -> an instance."""
    if isinstance(spec, AggregationStrategy):
        if options:
            raise ValueError(f"cannot apply options {sorted(options)} to an "
                             "already-constructed strategy instance")
        return spec
    return get(str(spec), **options)

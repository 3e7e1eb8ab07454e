"""String-keyed strategy registry.

``get("colrel", fused="kernel")`` instantiates a registered factory;
``register`` opens the family to new schemes.  ``resolve`` is the single
funnel every legacy spelling goes through: ``Aggregation`` enum values,
plain strings, already-built instances, and the two deprecated fused
knobs (``Aggregation.COLREL_FUSED`` and ``RoundConfig.use_fused_kernel``),
which warn and forward onto the ``colrel`` strategy's ``fused`` option.

``available(include_deprecated=True)`` also lists the warning aliases;
``canonical_name`` maps any spelling to its registry key without
instantiating.
"""

from __future__ import annotations

import enum
import warnings
from typing import Callable, Dict, Optional, Tuple

from repro_torch.strategies.base import AggregationStrategy

__all__ = ["register", "register_deprecated_alias", "get", "available", "canonical_name",
           "resolve"]

_FACTORIES: Dict[str, Callable[..., AggregationStrategy]] = {}
# alias -> (target name, implied options, warning message)
_ALIASES: Dict[str, Tuple[str, dict, str]] = {}


def register(name: str, factory: Optional[Callable[..., AggregationStrategy]] = None):
    """Register a strategy factory (class or callable) under ``name``;
    usable directly or as a class decorator."""

    def _do(f: Callable[..., AggregationStrategy]):
        if name in _FACTORIES or name in _ALIASES:
            raise ValueError(f"strategy {name!r} already registered")
        _FACTORIES[name] = f
        return f

    return _do if factory is None else _do(factory)


def register_deprecated_alias(alias: str, target: str, message: str, **options) -> None:
    """Register ``alias`` to resolve to ``get(target, **options)`` with a
    ``DeprecationWarning`` carrying ``message``."""
    if alias in _FACTORIES or alias in _ALIASES:
        raise ValueError(f"strategy {alias!r} already registered")
    _ALIASES[alias] = (target, options, message)


def available(*, include_deprecated: bool = False) -> Tuple[str, ...]:
    """Registered strategy names (deprecated aliases excluded by default)."""
    names = set(_FACTORIES)
    if include_deprecated:
        names |= set(_ALIASES)
    return tuple(sorted(names))


def _as_name(spec) -> str:
    return str(spec.value if isinstance(spec, enum.Enum) else spec)


def canonical_name(spec) -> str:
    """The registry name of any spelling, without instantiating or warning."""
    if isinstance(spec, AggregationStrategy):
        return spec.name
    name = _as_name(spec)
    if name in _ALIASES:
        return _ALIASES[name][0]
    if name not in _FACTORIES:
        raise KeyError(f"unknown aggregation strategy {name!r}; have {available()}")
    return name


def get(name, **options) -> AggregationStrategy:
    """Instantiate a registered strategy by name (enum values accepted)."""
    name = _as_name(name)
    if name in _ALIASES:
        target, implied, message = _ALIASES[name]
        warnings.warn(message, DeprecationWarning, stacklevel=2)
        return get(target, **{**implied, **options})
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise KeyError(f"unknown aggregation strategy {name!r}; have {available()}") from None
    strategy = factory(**options)
    if not isinstance(strategy, AggregationStrategy):
        raise TypeError(f"factory for {name!r} returned {type(strategy).__name__}, "
                        "not an AggregationStrategy")
    return strategy


def resolve(spec, *, fused_kernel: bool = False, **options) -> AggregationStrategy:
    """Any strategy spelling -> an instance.

    ``spec`` is an :class:`AggregationStrategy` (returned as it is), a
    registry name or an ``Aggregation`` value.  ``fused_kernel=True`` is
    the deprecated ``RoundConfig`` boolean: it forwards to the colrel
    strategy's ``fused="kernel"`` and warns.
    """
    if fused_kernel:
        if canonical_name(spec) != "colrel":
            raise ValueError("use_fused_kernel only applies to the colrel strategy "
                             f"(got {spec!r}); it would be silently inert")
        warnings.warn("use_fused_kernel is deprecated; use "
                      "strategies.get('colrel', fused='kernel') instead",
                      DeprecationWarning, stacklevel=2)
        if isinstance(spec, AggregationStrategy):
            spec = "colrel"
        return get(spec, fused="kernel", **options)
    if isinstance(spec, AggregationStrategy):
        if options:
            raise ValueError(f"cannot apply options {sorted(options)} to an "
                             "already-constructed strategy instance")
        return spec
    return get(spec, **options)

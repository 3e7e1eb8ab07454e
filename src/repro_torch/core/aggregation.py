"""Legacy aggregation entry points, thin shims over
:mod:`repro_torch.strategies` (the port of ``repro.core.aggregation``).

``Aggregation`` is the enum of the paper's five original schemes; every
value resolves through the strategy registry.  ``COLREL_FUSED`` is
deprecated: it forwards, with a warning, to the ``colrel`` strategy's
``fused="collapse"`` execution option, as ``RoundConfig.use_fused_kernel``
forwards to ``fused="kernel"``.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

__all__ = ["Aggregation", "aggregate"]


class Aggregation(str, enum.Enum):
    """Paper Sec. V strategies (registry names; the open set is
    ``repro_torch.strategies.available()``)."""

    COLREL = "colrel"                  # the paper's scheme (faithful path)
    COLREL_FUSED = "colrel_fused"      # DEPRECATED: colrel with fused="collapse"
    FEDAVG_PERFECT = "fedavg_perfect"  # upper bound: everyone always arrives
    FEDAVG_BLIND = "fedavg_blind"      # sum of arrivals / n (OAC-style)
    FEDAVG_NONBLIND = "fedavg_nonblind"  # sum of arrivals / #arrivals


def aggregate(
    strategy,
    updates: torch.Tensor,
    *,
    tau_up: torch.Tensor,
    tau_dd: Optional[torch.Tensor] = None,
    A: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Global delta ``(d,)`` from stacked client updates ``(n, d)``.

    ``strategy`` is a registry name, an ``Aggregation`` value or an
    :class:`~repro_torch.strategies.AggregationStrategy` instance.  The
    call is stateless: carried state is initialized and discarded (use the
    strategy object directly to thread state across rounds).
    """
    from repro_torch import strategies as _strategies  # deferred: core loads first

    s = _strategies.resolve(strategy)
    if s.needs_A and (A is None or tau_dd is None):
        raise ValueError(f"{s.name} needs A and tau_dd")
    state = s.init_state(updates.shape[0], updates.shape[-1], device=updates.device)
    delta, _ = s.aggregate(updates, tau_up, tau_dd, A, state)
    return delta

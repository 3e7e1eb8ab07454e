"""Asynchronous opportunistic relaying: staleness-weighted aggregation
over a device-resident staging buffer (the port of
``repro.strategies.async_relay``).

The paper's rounds are synchronous: a client whose uplink is blocked
contributes nothing that round.  Here the PS aggregates each client's
*last delivered* update, down-weighted by how stale it is, and a blocked
client's fresh update still gets out when a connected peer heard its D2D
broadcast and relays it.

``AsyncRelayStrategy`` wraps an inner
:class:`~repro_torch.strategies.base.AggregationStrategy` (``colrel`` by
default) and carries, inside the round's ``agg_state``:

* ``age`` — ``(n,)`` int32: rounds since each client's update last
  reached the PS.  It resets to 0 on delivery and increments otherwise.
* ``staging`` — ``(n, d)`` f32: each client's last delivered flat update.

**Delivery.**  Client ``i``'s fresh update reaches the PS iff its own
uplink is up (``tau_up[i]``) or, when ``opportunistic``, some peer ``j``
that heard it (``tau_dd[i, j]``) has its uplink up.  Clustered
``(C, m, m)`` block taus take the intra-cluster form.

**Staleness weighting.**  Client ``i``'s multiplier is
``n * gamma**age_i / sum_j gamma**age_j``, so the total mass stays ``n``
and the inner scheme sees full participation (``tau_up = 1``).  With
zero blockage every age is 0, every multiplier is exactly ``1.0`` and
the round is bitwise the sync inner strategy's.

**Execution.**  The monolithic path ravels the update tree once, advances
the carry, and hands the re-stacked effective tree to the inner scheme,
whose own path (faithful, collapse, kernel) applies: over ``colrel`` with
``fused="kernel"`` that is one launch of the fused aggregation kernel a
round, over ``clustered`` one of the blocked kernel.  With
``ctx.use_segments(d)`` (and a stateless, collapsible inner scheme) each
leaf's delivered rows are written into its columns of the staging buffer
and the staleness multipliers fold into the inner scheme's collapsed
weight row, so the PS delta is one row-stream launch over the whole
contiguous staging buffer (its columns are the leaf segments, in order).
The fold reassociates one product, so that delta agrees with the
monolithic one at f32 tolerance, while ``age`` and ``staging`` are
bitwise equal.

**Donation.**  The segmented path writes the staging buffer it is given
in place and returns the same tensor as the next state, as the memory
strategy's kernel paths do with their buffer; the monolithic path returns
a new one.  A caller that keeps an earlier state clones it first (the
trainer's ``donate=False`` does).
"""

from __future__ import annotations

import torch

from repro_torch.core import flatten
from repro_torch.kernels import ops as kernel_ops
from repro_torch.strategies import registry
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext, State

__all__ = ["AsyncRelayStrategy", "delivered_mask"]


def delivered_mask(tau_up: torch.Tensor, tau_dd: torch.Tensor, *,
                   opportunistic: bool = True) -> torch.Tensor:
    """(n,) f32 indicator of whose fresh update reaches the PS this round.

    ``tau_dd[i, j]``: client ``i``'s D2D broadcast reached peer ``j``, who
    can relay it when ``tau_up[j]``.  ``(C, m, m)`` block taus take the
    intra-cluster form."""
    t = tau_up.float()
    if not opportunistic:
        return t
    dd = tau_dd.float()
    if dd.ndim == 3:  # clustered block form
        C, m = dd.shape[0], dd.shape[1]
        relayed = torch.amax(dd * t.reshape(C, m)[:, None, :], dim=2).reshape(-1)
    else:
        relayed = torch.amax(dd * t[None, :], dim=1)
    return torch.maximum(t, relayed)


class AsyncRelayStrategy(AggregationStrategy):
    """Staleness-weighted async aggregation around an inner scheme."""

    name = "async_colrel"
    scalar_collapsible = False  # the staged stack must materialize
    stateful = True  # {"age", "staging", "inner"}
    #: marks the async family for the round and trainer plumbing
    is_async = True

    def __init__(self, inner="colrel", gamma: float = 0.9, opportunistic: bool = True,
                 inner_options=None):
        self.inner = registry.resolve(inner, **dict(inner_options or {}))
        if getattr(self.inner, "is_async", False):
            raise ValueError("async strategies do not nest")
        if not 0.0 < float(gamma) <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got {gamma!r}")
        self.gamma = float(gamma)
        self.opportunistic = bool(opportunistic)
        # proxy the inner scheme's connectivity contract
        self.needs_A = self.inner.needs_A
        self.name = f"async_{self.inner.name}"

    @property
    def calibration_tracks_A(self) -> bool:
        return self.inner.calibration_tracks_A

    def calibrate(self, model, A) -> "AsyncRelayStrategy":
        inner = self.inner.calibrate(model, A)
        if inner is self.inner:
            return self
        return AsyncRelayStrategy(inner=inner, gamma=self.gamma,
                                  opportunistic=self.opportunistic)

    def wire_bits_per_coord(self, d: int) -> float:
        return self.inner.wire_bits_per_coord(d)

    # -- state -----------------------------------------------------------
    def init_state(self, n: int, d: int, *, device=None) -> State:
        return {
            "age": torch.zeros((n,), dtype=torch.int32, device=device),
            "staging": torch.zeros((n, d), dtype=torch.float32, device=device),
            "inner": self.inner.init_state(n, d, device=device),
        }

    def checkpoint_state(self, state: State):
        return {"age": state["age"], "staging": state["staging"],
                "inner": self.inner.checkpoint_state(state["inner"])}

    def restore_state(self, saved, *, device=None, like=None) -> State:
        return {"age": torch.as_tensor(saved["age"], dtype=torch.int32, device=device),
                "staging": torch.as_tensor(saved["staging"], dtype=torch.float32,
                                           device=device),
                "inner": self.inner.restore_state(
                    saved["inner"], device=device,
                    like=like["inner"] if like is not None else None)}

    # -- the async carry --------------------------------------------------
    @staticmethod
    def _advance_age(age: torch.Tensor, deliv: torch.Tensor) -> torch.Tensor:
        """Where-free age recurrence: ``deliv`` is an exact {0., 1.}
        indicator, so ``(age + 1) * (1 - deliv)`` in int32 is bitwise the
        select form."""
        return ((age + 1) * (1 - deliv.to(torch.int32))).to(torch.int32)

    def advance(self, age, staging, stack, tau_up, tau_dd):
        """One step of the carry recurrence: ``(delivered, age', staging')``.
        Delivered clients refresh their staged row and reset to age 0;
        blocked clients keep aging."""
        deliv = delivered_mask(tau_up, tau_dd, opportunistic=self.opportunistic)
        age = self._advance_age(age, deliv)
        staging = torch.where(deliv[:, None] > 0, stack.to(staging.dtype), staging)
        return deliv, age, staging

    def _multipliers(self, age: torch.Tensor) -> torch.Tensor:
        """``n * gamma**age / sum gamma**age``: exactly 1.0 per client when
        every age is 0."""
        s = torch.pow(self.gamma, age.float())
        total = torch.sum(s)
        # n / total as a true division (``int / tensor`` multiplies by the
        # reciprocal), from a device fill that a captured round can replay
        return s * (torch.full_like(total, age.shape[0]) / total)

    def staleness_weights(self, age: torch.Tensor) -> torch.Tensor:
        """Normalized decay ``gamma**age / sum gamma**age`` (sums to 1)."""
        s = torch.pow(self.gamma, age.float())
        return s / torch.sum(s)

    def _effective(self, age: torch.Tensor, staging: torch.Tensor) -> torch.Tensor:
        """Staleness-weighted staged stack with total mass ``n``."""
        return self._multipliers(age)[:, None] * staging

    # -- aggregation ------------------------------------------------------
    def aggregate(self, updates, tau_up, tau_dd, A, state: State):
        _, age, staging = self.advance(state["age"], state["staging"], updates, tau_up, tau_dd)
        delta, inner_state = self.inner.aggregate(
            self._effective(age, staging), torch.ones_like(tau_up), tau_dd, A, state["inner"])
        return delta, {"age": age, "staging": staging, "inner": inner_state}

    def aggregate_tree(self, deltas, tau_up, tau_dd, A, state, ctx: ExecutionContext):
        spec = flatten.flat_spec(deltas, stacked=True)
        if (ctx.use_segments(spec.d) and not self.inner.stateful
                and self.inner.scalar_collapsible):
            return self._aggregate_segments(deltas, spec, tau_up, tau_dd, A, state, ctx)
        # ravel once into the staging layout, advance the carry, then hand
        # the re-stacked effective tree to the inner scheme, whose own
        # execution path still applies
        stack = flatten.ravel_stacked(deltas, dtype=ctx.flat_dtype)
        _, age, staging = self.advance(state["age"], state["staging"], stack, tau_up, tau_dd)
        eff_tree = flatten.unravel_stacked(spec, self._effective(age, staging),
                                           dtype=torch.float32)
        gdelta, inner_state = self.inner.aggregate_tree(
            eff_tree, torch.ones_like(tau_up), tau_dd, A, state["inner"], ctx)
        return gdelta, {"age": age, "staging": staging, "inner": inner_state}

    def _aggregate_segments(self, deltas, spec, tau_up, tau_dd, A, state, ctx):
        """Segment-streaming async round: the staging buffer is the only
        (n, d) tensor.  Each leaf's delivered rows are selected into its
        columns in place, and the multipliers fold into the inner scheme's
        collapsed weight row, so the delta is one row-stream launch over the
        staging buffer, whose columns are the leaf segments in order."""
        deliv = delivered_mask(tau_up, tau_dd, opportunistic=self.opportunistic)
        age = self._advance_age(state["age"], deliv)
        staging = state["staging"]
        refresh = deliv[:, None] > 0
        for seg, off, sz in zip(flatten.ravel_stacked_segments(deltas, dtype=ctx.flat_dtype),
                                spec.offsets, spec.sizes):
            cols = staging[:, off:off + sz]
            cols.copy_(torch.where(refresh, seg.to(staging.dtype), cols))
        w_eff = self.inner.weights(torch.ones_like(tau_up), tau_dd, A) * self._multipliers(age)
        gflat = kernel_ops.row_stream(w_eff, staging, block_d=ctx.fused_block_d)
        return (flatten.unravel(spec, gflat, dtype=torch.float32),
                {"age": age, "staging": staging, "inner": state["inner"]})

    def __repr__(self) -> str:
        return (f"AsyncRelayStrategy(inner={self.inner.name!r}, gamma={self.gamma!r}, "
                f"opportunistic={self.opportunistic!r})")


registry.register("async_colrel", AsyncRelayStrategy)

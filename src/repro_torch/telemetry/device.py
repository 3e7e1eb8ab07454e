"""Device-resident telemetry: vector metrics computed inside the round.

The port of ``repro.telemetry.device``.  The paper's argument is about
*who got through*, so the fleet-scalar ``participation`` stream is not
enough to observe a run.  The instrumented round adds the per-client view
without any mid-chunk host traffic:

* ``client_participation (n,)`` — this round's realized uplink vector
  ``tau_up``: which clients' updates reached the PS;
* ``client_uplink_bits (n,)`` — per-client bits on air at the active wire
  codec's rate (the per-client decomposition of ``uplink_bits``);
* ``outage_streak (n,)`` — consecutive rounds (this one included) each
  client's uplink has been down, an int32 age vector carried across
  rounds like the channel's gate state;
* ``weight_drift`` — ``|sum(w) - 1|``, the realized unbiasedness drift of
  the scalar aggregation weights (NaN where there is no scalar collapse).

In the chunked engine the vectors come back ``(K, n)`` per chunk from
their own device buffers, each in its own dtype; the per-round loop sees
the same ``(n,)`` values one round at a time.  Every operation is
lane-local in the client dimension.
"""

from __future__ import annotations

import torch

from repro_torch.core import flatten

__all__ = ["VECTOR_METRICS", "VECTOR_DTYPES", "init_streak", "update_streak",
           "instrument_round_fn"]

#: the vector metric streams added by :func:`instrument_round_fn`, each
#: ``(n,)`` a round and ``(K, n)`` a chunk, with their dtypes: the streak
#: stays int32 end to end
VECTOR_DTYPES = {"client_participation": torch.float32,
                 "client_uplink_bits": torch.float32,
                 "outage_streak": torch.int32}
VECTOR_METRICS = tuple(VECTOR_DTYPES)


def init_streak(n: int, device=None) -> torch.Tensor:
    """Zeroed ``(n,)`` int32 outage-age vector (no observed history)."""
    return torch.zeros((n,), dtype=torch.int32, device=device)


def update_streak(streak: torch.Tensor, tau_up: torch.Tensor) -> torch.Tensor:
    """Advance the outage-streak recurrence one round: a delivered uplink
    resets to 0, a blocked one increments."""
    return torch.where(tau_up > 0, 0, streak + 1).to(torch.int32)


def instrument_round_fn(round_fn, wire_bits_per_coord):
    """Wrap a round body with the device-resident vector metrics.

    The wrapped signature grows one trailing carry argument and result::

        wrapped(params, server_state, agg_state, batches,
                tau_up, tau_dd, A, streak)
            -> (params, server_state, agg_state, streak, metrics)

    ``metrics`` is the base round's dict plus the :data:`VECTOR_METRICS`
    vectors and the ``weight_drift`` scalar.  The wrapper only reads the
    base body's inputs and outputs, so the trajectory and the scalar
    streams are bitwise those of the base round.  ``metric_keys`` names the
    scalars (the base round's and ``weight_drift``) and ``vector_dtypes``
    the vectors with their dtypes, which the chunked engine's buffers need.
    """

    def wrapped(params, server_state, agg_state, batches, tau_up, tau_dd, A, streak):
        params, server_state, agg_state, metrics = round_fn(
            params, server_state, agg_state, batches, tau_up, tau_dd, A)
        streak = update_streak(streak, tau_up)
        d_flat = flatten.flat_spec(params).d
        part = tau_up.float()
        metrics = dict(
            metrics,
            client_participation=part,
            client_uplink_bits=part * float(d_flat * wire_bits_per_coord(d_flat)),
            outage_streak=streak,
            weight_drift=torch.abs(metrics["weight_sum"] - 1.0),
        )
        return params, server_state, agg_state, streak, metrics

    wrapped.metric_keys = tuple(round_fn.metric_keys) + ("weight_drift",)
    wrapped.vector_dtypes = dict(VECTOR_DTYPES)
    return wrapped

"""Online estimation of the link statistics ``(p, P, E)`` from realized taus.

COPT-alpha assumes the PS knows the link probabilities.  Under unknown or
drifting channels the PS only observes connectivity realizations: uplink
successes directly, D2D receptions from the clients' reports piggybacked
on their uploads (the simulation assumes the tau tensors of every round
are observed in full).

:class:`LinkEstimator` keeps exponentially-forgetting Beta-posterior
counts per link:

    s <- gamma * s + tau,   t <- gamma * t + 1,
    hat = (s + a) / (t + a + b)                       (posterior mean)

``gamma = 1`` is the full Beta(a, b) posterior (right for stationary
chains); ``gamma < 1`` is an EWMA with effective window ``1/(1-gamma)``
(right for mobility drift).  Reciprocity ``E`` is estimated from the
per-pair joint successes ``tau_ij * tau_ji`` the same way.

:meth:`LinkEstimator.estimated_model` projects the raw estimates onto the
:class:`LinkModel` feasible set (unit diagonals, symmetric ``E`` inside
the Fréchet bounds and above independence), ready for
:func:`repro_torch.core.weights.optimize_weights`.

The port of ``repro.channel.estimator``: the same numpy arithmetic in the
same order, so the same taus give the reference's estimates bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.connectivity import LinkModel

__all__ = ["LinkEstimator"]


class LinkEstimator:
    """Streaming ``(p, P, E)`` estimates from observed tau realizations."""

    def __init__(self, n: int, *, prior: tuple[float, float] = (0.5, 0.5),
                 decay: float = 1.0, prune_below: float = 0.0):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if prior[0] <= 0 or prior[1] <= 0:
            raise ValueError("prior pseudo-counts must be positive")
        self.n = int(n)
        self.prior = (float(prior[0]), float(prior[1]))
        self.decay = float(decay)
        self.prune_below = float(prune_below)
        self.rounds = 0
        self._t = 0.0  # discounted round count (shared: every link observed)
        self._s_up = np.zeros(n)
        self._s_dd = np.zeros((n, n))
        self._s_joint = np.zeros((n, n))  # successes of tau_ij * tau_ji

    def update(self, tau_up: np.ndarray, tau_dd: np.ndarray) -> None:
        tau_up = np.asarray(tau_up, dtype=np.float64)
        tau_dd = np.asarray(tau_dd, dtype=np.float64)
        g = self.decay
        self._t = g * self._t + 1.0
        self._s_up = g * self._s_up + tau_up
        self._s_dd = g * self._s_dd + tau_dd
        self._s_joint = g * self._s_joint + tau_dd * tau_dd.T
        self.rounds += 1

    def checkpoint_state(self) -> dict:
        """The full posterior: discounted counts and the round tally."""
        return {
            "rounds": int(self.rounds),
            "t": float(self._t),
            "s_up": np.array(self._s_up),
            "s_dd": np.array(self._s_dd),
            "s_joint": np.array(self._s_joint),
        }

    def restore_state(self, state: dict) -> None:
        self.rounds = int(state["rounds"])
        self._t = float(state["t"])
        self._s_up = np.asarray(state["s_up"], np.float64)
        self._s_dd = np.asarray(state["s_dd"], np.float64)
        self._s_joint = np.asarray(state["s_joint"], np.float64)

    # -- raw posterior means ------------------------------------------
    def _mean(self, s: np.ndarray) -> np.ndarray:
        a, b = self.prior
        return (s + a) / (self._t + a + b)

    @property
    def p_hat(self) -> np.ndarray:
        return self._mean(self._s_up)

    @property
    def P_hat(self) -> np.ndarray:
        P = self._mean(self._s_dd)
        np.fill_diagonal(P, 1.0)
        return P

    @property
    def E_hat(self) -> np.ndarray:
        E = self._mean(self._s_joint)
        E = 0.5 * (E + E.T)  # symmetrize (counts drift apart only via fp)
        np.fill_diagonal(E, 1.0)
        return E

    # -- projection to a feasible LinkModel ---------------------------
    def estimated_model(self) -> LinkModel:
        """Project ``(p_hat, P_hat, E_hat)`` onto the LinkModel feasible set.

        With ``prune_below > 0``, off-diagonal ``P`` entries under the
        threshold are zeroed: phantom links kept alive only by the prior
        would otherwise receive (high-variance) relay weight.
        """
        p = np.clip(self.p_hat, 0.0, 1.0)
        P = np.clip(self.P_hat, 0.0, 1.0)
        if self.prune_below > 0.0:
            off = ~np.eye(self.n, dtype=bool)
            P[off & (P < self.prune_below)] = 0.0
        np.fill_diagonal(P, 1.0)
        lo = np.maximum(P * P.T, np.maximum(0.0, P + P.T - 1.0))
        hi = np.minimum(P, P.T)
        E = np.clip(self.E_hat, lo, hi)
        E = 0.5 * (E + E.T)
        np.fill_diagonal(E, 1.0)
        return LinkModel(p, P, E)

    def errors(self, true_model: LinkModel) -> Dict[str, float]:
        """Max-abs estimation errors against an oracle model (logging)."""
        off = ~np.eye(self.n, dtype=bool)
        return {
            "p": float(np.max(np.abs(self.p_hat - true_model.p))),
            "P": float(np.max(np.abs((self.P_hat - true_model.P)[off]))),
            "E": float(np.max(np.abs((self.E_hat - true_model.E)[off]))),
        }

"""Adaptive consensus weights: estimate links online, re-run COPT-alpha.

ColRel's alpha matrix is computed once from oracle link statistics; under
unknown, bursty or drifting channels the PS must learn ``(p, P, E)`` from
the realizations it sees and re-optimize from time to time.
:class:`AdaptiveWeightSchedule` owns a
:class:`~repro_torch.channel.estimator.LinkEstimator` and, every ``every``
rounds (after ``warmup``), runs
:func:`repro_torch.core.weights.optimize_weights` on the estimated model.

The port of ``repro.channel.schedule``: host numpy, calling the port's
``optimize_weights`` (the reference's arithmetic), so the same taus give
the reference's events and alphas bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.channel.estimator import LinkEstimator
from repro_torch.core.weights import optimize_weights

__all__ = ["AdaptiveConfig", "AdaptiveWeightSchedule"]


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    every: int = 50  # re-optimization cadence K (rounds)
    warmup: int = 20  # min observed rounds before the first re-opt
    sweeps: int = 10  # COPT-alpha relax sweeps per re-opt
    fine_tune_sweeps: int = 10
    decay: float = 1.0  # estimator forgetting (1 = posterior, <1 = EWMA)
    prior: tuple = (0.5, 0.5)
    prune_below: float = 0.0

    def __post_init__(self):
        if self.every <= 0:
            raise ValueError("every must be positive")


class AdaptiveWeightSchedule:
    """Observe taus every round; hand back a fresh alpha every K rounds."""

    def __init__(self, n: int, cfg: AdaptiveConfig = AdaptiveConfig()):
        self.cfg = cfg
        self.estimator = LinkEstimator(n, prior=cfg.prior, decay=cfg.decay,
                                       prune_below=cfg.prune_below)
        self.events: List[Dict[str, Any]] = []

    def checkpoint_state(self) -> dict:
        """The estimator's posterior and the re-opt event log, the log as one
        JSON string (its values may be numpy scalars, which ``.item()``
        makes plain)."""
        return {"estimator": self.estimator.checkpoint_state(),
                "events": json.dumps(self.events, default=lambda o: o.item())}

    def restore_state(self, state: dict) -> None:
        self.estimator.restore_state(state["estimator"])
        self.events = json.loads(state["events"])

    def step(self, r: int, tau_up: np.ndarray, tau_dd: np.ndarray) -> Optional[np.ndarray]:
        """Ingest round r's realization; return a new A on re-opt rounds.

        Returns ``None`` on other rounds.  Re-opts fire on the last round of
        each cadence window once ``warmup`` rounds were seen.
        """
        self.estimator.update(tau_up, tau_dd)
        seen = self.estimator.rounds
        if seen < self.cfg.warmup or (r + 1) % self.cfg.every != 0:
            return None
        res = optimize_weights(self.estimator.estimated_model(), sweeps=self.cfg.sweeps,
                               fine_tune_sweeps=self.cfg.fine_tune_sweeps)
        self.events.append({"round": r, "seen": seen, "S_est": res.S,
                            "converged": res.converged})
        return res.A

"""Random-waypoint client mobility over the mmWave geometry.

Clients move on a 2-D plane (PS fixed) toward uniformly re-drawn
waypoints at a constant speed; every ``epoch`` rounds the geometric
mmWave :class:`LinkModel` is re-derived from the current positions via
:func:`repro_torch.core.topology.mmwave_geometric` — so the marginals
``p`` and ``P`` drift and yesterday's optimal relay weights go stale.
Within an epoch, rounds are sampled i.i.d. from the epoch's model (the
paper's static law), which keeps the drift attributable to geometry.

The port of ``repro.channel.mobility``: numpy on the host throughout,
drawing positions, waypoints and taus from one ``np.random.Generator``
in the reference's order, so one seed gives the reference's taus,
positions and per-epoch models bit for bit.  There is no in-scan
sampler (the geometry lives on the host), so ``run(..., no_trace=True)``
refuses a mobility channel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.channel.base import stacked_trace
from repro_torch.ckpt.schema import rng_from_json, rng_state_to_json
from repro_torch.core.connectivity import LinkModel, sample_round
from repro_torch.core.topology import mmwave_geometric

__all__ = ["MobilityChannel"]


class MobilityChannel:
    """Waypoint trajectories re-deriving the mmWave ``LinkModel`` per epoch.

    Parameters
    ----------
    n: number of clients.
    area: half-width (meters) of the square region (centered on the PS)
        clients roam in.  The mmWave uplink dies off beyond ~250 m, so
        ``area ~ 300`` keeps clients drifting in and out of coverage.
    speed: meters moved per round.
    epoch: rounds between geometry refreshes (the model is piecewise
        static over epochs).
    init_positions: optional (n, 2) starting coordinates; random
        uniform in the region otherwise.
    """

    def __init__(
        self,
        n: int,
        *,
        area: float = 300.0,
        speed: float = 4.0,
        epoch: int = 20,
        seed: int = 0,
        ps_position: Sequence[float] = (0.0, 0.0),
        d2d_mode: str = "intermittent",
        rho: float = 0.0,
        init_positions: Optional[np.ndarray] = None,
    ):
        if epoch <= 0:
            raise ValueError("epoch must be positive")
        self._n = int(n)
        self.area = float(area)
        self.speed = float(speed)
        self.epoch = int(epoch)
        self.ps_position = tuple(ps_position)
        self.d2d_mode = d2d_mode
        self.rho = rho
        self._rng = np.random.default_rng(seed)
        if init_positions is not None:
            self.positions = np.array(init_positions, dtype=np.float64)
            if self.positions.shape != (self._n, 2):
                raise ValueError(f"init_positions must be ({n}, 2)")
        else:
            self.positions = self._draw_points(self._n)
        self._waypoints = self._draw_points(self._n)
        self._next = 0
        self._models: Dict[int, LinkModel] = {0: self._derive_model()}  # epoch -> model

    # -- geometry ------------------------------------------------------
    def _draw_points(self, k: int) -> np.ndarray:
        return self._rng.uniform(-self.area, self.area, size=(k, 2))

    def _derive_model(self) -> LinkModel:
        return mmwave_geometric(self.positions, self.ps_position, d2d_mode=self.d2d_mode,
                                rho=self.rho)

    def _advance(self) -> None:
        """Move every client one round toward its waypoint."""
        d = self._waypoints - self.positions
        dist = np.linalg.norm(d, axis=1)
        arrived = dist <= self.speed
        step = np.where(arrived[:, None], d,
                        d * (self.speed / np.maximum(dist, 1e-12))[:, None])
        self.positions = self.positions + step
        if arrived.any():
            self._waypoints[arrived] = self._draw_points(int(arrived.sum()))

    # -- the channel protocol ------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    def tau_for_round(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        if r != self._next:
            raise ValueError(
                f"MobilityChannel serves rounds in order; expected {self._next}, got {r}")
        self._next += 1
        e = r // self.epoch
        if e not in self._models:
            self._models[e] = self._derive_model()
        tau = sample_round(self._models[e], self._rng)
        self._advance()
        return tau

    def trace(self, start: int, rounds: int) -> tuple[np.ndarray, np.ndarray]:
        # the geometry advances (and may be re-derived) every round, so
        # there is no block to vectorize
        return stacked_trace(self, start, rounds)

    def checkpoint_state(self) -> dict:
        """The full mobility state: the numpy stream, the geometry, and the
        derived models of the current and later epochs.  The current
        epoch's model was derived from positions at the epoch boundary,
        which no longer exist mid-epoch, so it travels in the checkpoint;
        earlier epochs are never served again and are dropped."""
        cur = self._next // self.epoch
        return {
            "kind": type(self).__name__,
            "rng": rng_state_to_json(self._rng),
            "positions": np.array(self.positions),
            "waypoints": np.array(self._waypoints),
            "next": int(self._next),
            "models": {str(e): {"p": np.asarray(m.p), "P": np.asarray(m.P),
                                "E": np.asarray(m.E)}
                       for e, m in self._models.items() if e >= cur},
        }

    def restore_state(self, state: dict) -> None:
        if state.get("kind") != type(self).__name__:
            raise ValueError(f"checkpoint is for channel {state.get('kind')!r}; this "
                             f"is a {type(self).__name__}")
        self._rng = rng_from_json(state["rng"])
        self.positions = np.asarray(state["positions"], np.float64)
        self._waypoints = np.asarray(state["waypoints"], np.float64)
        self._next = int(state["next"])
        self._models = {int(e): LinkModel(np.asarray(m["p"]), np.asarray(m["P"]),
                                          np.asarray(m["E"]))
                        for e, m in state["models"].items()}

    def model_for_round(self, r: int) -> LinkModel:
        e = r // self.epoch
        if e not in self._models:
            raise ValueError(f"epoch {e} not reached yet (round {r})")
        return self._models[e]

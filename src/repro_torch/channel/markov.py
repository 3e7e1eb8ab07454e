"""Gilbert–Elliott bursty blockage chains (numpy).

Each link carries a hidden two-state *gate* chain (Good/Bad — the mmWave
blocker): in Bad the link is down; in Good the link succeeds with the
conditional probability that restores the target per-round marginal.
The gate chain is parameterized by its stationary Good occupancy ``pi``
and its *memory* ``lam`` (the chain's second eigenvalue = the lag-1
autocorrelation of the gate):

    P(Bad -> Good)  = g = (1 - lam) * pi
    P(Good -> Bad)  = b = (1 - lam) * (1 - pi)

so the stationary law is ``Bernoulli(pi)`` for every ``lam`` and the
expected blockage burst lasts ``1/g`` rounds.  ``lam = 0`` recovers the
paper's i.i.d. channel: gates are drawn fresh every round and the
per-round law of ``(tau_up, tau_dd)`` coincides with
:func:`repro_torch.core.connectivity.sample_round` for the same
:class:`LinkModel` — burstiness is added without moving any marginal.

D2D pairs keep channel reciprocity: each unordered pair {i<j} shares one
gate chain (a blocker obstructs both directions), and conditional on
Good the ordered pair ``(tau_ij, tau_ji)`` is drawn from the same
one-uniform coupling as the static sampler, with the good-state joint
``E/pi`` preserving ``E[tau_ij tau_ji] = E_ij`` unconditionally.

The port of ``repro.channel.markov``'s host side: :class:`GEParams`,
:func:`gilbert_elliott` and the per-round loop
:func:`sample_ge_rounds_host` (the law's specification) are copied as
they are.  :class:`MarkovChannel` generates ``block`` rounds at a time
from the chains' carried state with an explicit numpy ``Generator``
seeded from ``seed``: the reference draws its stream from ``jax.random``,
which cannot be reproduced here, so the two agree in law, not draw for
draw.

:func:`ge_scan_sampler` is the in-scan sampler of the chunked engine's
no-trace mode: the reference's integer thresholds on a 15-bit lattice
(:func:`_device_arrays`), one round per call from a ``torch.Generator``,
with the packed ``(n + m,)`` gate state carried as one device tensor and
updated in place.  :func:`sample_ge_rounds` runs it ``rounds`` times from
stationary starts: a whole trace on the generator's device in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.channel.base import BlockBufferedChannel, gather_pairs, pair_lane_table
from repro_torch.core.connectivity import LinkModel

__all__ = [
    "GEParams",
    "gilbert_elliott",
    "sample_ge_rounds",
    "sample_ge_rounds_host",
    "ge_scan_sampler",
    "MarkovChannel",
]

_EPS = 1e-12
# the in-scan samplers' thresholds live on a 15-bit integer lattice:
# probabilities quantized to 2^-15, compared with 15-bit uniform integers
_LATTICE = 32768


@dataclasses.dataclass(frozen=True)
class GEParams:
    """Gilbert–Elliott chain parameters for every link of a ``LinkModel``.

    ``pi_*`` are stationary Good-state occupancies, ``lam_*`` the gate
    memories; uplinks are indexed ``0..n-1``, D2D gates by the unordered
    pair index of ``np.triu_indices(n, 1)``.
    """

    model: LinkModel
    pi_up: np.ndarray  # (n,)
    lam_up: np.ndarray  # (n,)
    pi_dd: np.ndarray  # (m,) one gate per unordered pair {i<j}
    lam_dd: np.ndarray  # (m,)

    @property
    def n(self) -> int:
        return self.model.n

    def pair_indices(self) -> tuple[np.ndarray, np.ndarray]:
        return np.triu_indices(self.n, k=1)

    def expected_bad_burst(self) -> tuple[np.ndarray, np.ndarray]:
        """Mean blockage sojourn (rounds) for uplink and pair gates."""
        g_up = (1.0 - self.lam_up) * self.pi_up
        g_dd = (1.0 - self.lam_dd) * self.pi_dd
        return 1.0 / np.maximum(g_up, _EPS), 1.0 / np.maximum(g_dd, _EPS)

    def lag1_uplink(self) -> np.ndarray:
        """Lag-1 autocorrelation of tau_up[i]: q (1-pi) lam / (1-p)."""
        p, pi = self.model.p, self.pi_up
        q = np.where(pi > 0, p / np.maximum(pi, _EPS), 0.0)
        denom = np.maximum(1.0 - p, _EPS)
        return np.where(p < 1.0, q * (1.0 - pi) * self.lam_up / denom, 0.0)


def _conditionals(params: GEParams):
    """Good-state conditional laws (q_up, qij, qji, e_cond) + pair index."""
    model, n = params.model, params.n
    iu, ju = params.pair_indices()
    q_up = np.where(params.pi_up > 0, model.p / np.maximum(params.pi_up, _EPS), 0.0)
    pi = np.maximum(params.pi_dd, _EPS)
    qij = model.P[iu, ju] / pi
    qji = model.P[ju, iu] / pi
    e_c = model.E[iu, ju] / pi
    return q_up, qij, qji, e_c, iu, ju


def gilbert_elliott(
    model: LinkModel,
    memory: Union[float, tuple[float, float]] = 0.9,
    occupancy: Optional[float] = None,
) -> GEParams:
    """Fit GE chains whose per-round law matches ``model`` exactly.

    Parameters
    ----------
    memory:
        Gate lag-1 autocorrelation ``lam`` in ``[0, 1)``; a scalar, or a
        ``(lam_uplink, lam_d2d)`` pair.  ``0`` = the i.i.d. paper model;
        ``0.9`` means blockage bursts ~10x longer than i.i.d. draws.
    occupancy:
        Target Good-state occupancy ``pi``.  ``None`` fits the *tightest*
        feasible gate (``pi_up = p_i``; for pairs the Fréchet-driven
        floor) so that burstiness is maximal; a float is clipped up to
        feasibility per link.  Links with zero marginal get an inert
        always-Good gate.

    Feasibility: marginals require ``pi >= p`` (uplink) and
    ``pi >= max(p_ij, p_ji, p_ij + p_ji - E_ij)`` (pair — the lower
    Fréchet bound of the Good-state coupling).
    """
    if isinstance(memory, tuple):
        lam_up_s, lam_dd_s = memory
    else:
        lam_up_s = lam_dd_s = float(memory)
    for lam in (lam_up_s, lam_dd_s):
        if not 0.0 <= lam < 1.0:
            raise ValueError(f"memory must be in [0, 1), got {lam}")

    n = model.n
    iu, ju = np.triu_indices(n, k=1)
    pij, pji, eij = model.P[iu, ju], model.P[ju, iu], model.E[iu, ju]

    floor_up = model.p
    floor_dd = np.maximum(np.maximum(pij, pji), pij + pji - eij)
    if occupancy is None:
        pi_up, pi_dd = floor_up.copy(), floor_dd.copy()
    else:
        if not 0.0 < occupancy <= 1.0:
            raise ValueError(f"occupancy must be in (0, 1], got {occupancy}")
        pi_up = np.maximum(floor_up, occupancy)
        pi_dd = np.maximum(floor_dd, occupancy)
    # inert links: permanently-Good gate, zero conditional success.
    pi_up = np.where(floor_up <= 0.0, 1.0, pi_up)
    pi_dd = np.where(floor_dd <= 0.0, 1.0, pi_dd)

    lam_up = np.full(n, lam_up_s)
    lam_dd = np.full(iu.shape[0], lam_dd_s)
    # gates pinned at pi == 1 have no dynamics to remember
    lam_up = np.where(pi_up >= 1.0, 0.0, lam_up)
    lam_dd = np.where(pi_dd >= 1.0, 0.0, lam_dd)
    return GEParams(model, pi_up, lam_up, pi_dd, lam_dd)


# ---------------------------------------------------------------------------
# Host-loop reference sampler (numpy, one python iteration per round)
# ---------------------------------------------------------------------------


def sample_ge_rounds_host(
    params: GEParams, rng: np.random.Generator, rounds: int
) -> tuple[np.ndarray, np.ndarray]:
    """Reference per-round loop: (R, n) uplinks and (R, n, n) D2D.

    Deliberately written in the same per-round idiom as the static
    :func:`~repro_torch.core.connectivity.sample_round` loop — one python
    iteration per round drawing an (n, n) uniform matrix with fresh
    pair-index extraction, the readable specification of the law.  Given
    the same numpy generator it draws the reference's taus exactly.
    """
    n = params.n
    q_up, qij, qji, e_c, _, _ = _conditionals(params)
    g_up = (1.0 - params.lam_up) * params.pi_up
    b_up = (1.0 - params.lam_up) * (1.0 - params.pi_up)
    g_dd = (1.0 - params.lam_dd) * params.pi_dd
    b_dd = (1.0 - params.lam_dd) * (1.0 - params.pi_dd)

    iu0, ju0 = params.pair_indices()
    su = rng.random(n) < params.pi_up
    sp = rng.random(iu0.shape[0]) < params.pi_dd
    ups = np.empty((rounds, n))
    dds = np.empty((rounds, n, n))
    for r in range(rounds):
        iu, ju = np.triu_indices(n, k=1)  # as sample_round does, per call
        # gate transitions: one uniform per link
        u1 = rng.random(n)
        su = np.where(su, u1 >= b_up, u1 < g_up)
        u2 = np.triu(rng.random((n, n)), k=1)[iu, ju]
        sp = np.where(sp, u2 >= b_dd, u2 < g_dd)
        # conditional emissions given Good gates
        ups[r] = su & (rng.random(n) < q_up)
        uu = np.triu(rng.random((n, n)), k=1)[iu, ju]
        tij = sp & (uu < qij)
        tji = sp & ((uu < e_c) | ((uu >= qij) & (uu < qij + qji - e_c)))
        dd = np.eye(n)
        dd[iu, ju] = tij
        dd[ju, iu] = tji
        dds[r] = dd
    return ups, dds


# ---------------------------------------------------------------------------
# In-scan sampler: one round per call, for taus drawn inside the captured round
# ---------------------------------------------------------------------------


def _lattice(p) -> np.ndarray:
    return np.rint(np.clip(p, 0.0, 1.0) * _LATTICE).astype(np.int64)


def _device_arrays(params: GEParams, device) -> dict:
    """The reference's integer-threshold operands (``int32`` here, the
    reference's ``uint16`` values), the pair-lane table and the stationary
    occupancies, on ``device``."""
    q_up, qij, qji, e_c, _, _ = _conditionals(params)
    thresh = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    # upper bound of the only-ji interval [t_qij, t_qij + t_qji - t_e),
    # summed on the host: it can exceed the lattice by the rounding slack
    t_mid = _lattice(qij) + _lattice(qji) - _lattice(e_c)
    return dict(
        t_g_up=thresh(_lattice((1.0 - params.lam_up) * params.pi_up)),
        t_b_up=thresh(_lattice((1.0 - params.lam_up) * (1.0 - params.pi_up))),
        t_g_dd=thresh(_lattice((1.0 - params.lam_dd) * params.pi_dd)),
        t_b_dd=thresh(_lattice((1.0 - params.lam_dd) * (1.0 - params.pi_dd))),
        t_q_up=thresh(_lattice(q_up)),
        t_qij=thresh(_lattice(qij)),
        t_qji=thresh(_lattice(qji)),
        t_e=thresh(_lattice(e_c)),
        t_mid=thresh(t_mid),
        pair_lane=torch.as_tensor(pair_lane_table(params.n), dtype=torch.int64, device=device),
        pi_up=torch.as_tensor(params.pi_up, dtype=torch.float32, device=device),
        pi_dd=torch.as_tensor(params.pi_dd, dtype=torch.float32, device=device),
    )


def _stationary_state(arrs: dict, gen: torch.Generator) -> torch.Tensor:
    """The packed ``(n + m,)`` bool gate state drawn from the chains'
    stationary law: uplink gates first, then one per unordered pair."""
    pi = torch.cat([arrs["pi_up"], arrs["pi_dd"]])
    return torch.rand(pi.shape, generator=gen, dtype=torch.float32, device=pi.device) < pi


def ge_scan_sampler(params: GEParams, device):
    """Per-round GE sampler for in-scan use on ``device``: ``(init_fn,
    sample_fn)``.

    ``init_fn(gen)`` draws the packed ``(n + m,)`` bool gate state from the
    stationary law; ``sample_fn(state, gen) -> (tau_up, tau_dd, state)``
    advances every gate chain one round, in place in ``state``, and emits
    that round's realization: one draw of ``2n + 2m`` 15-bit integers
    against the lattice thresholds, the single-step form of the bulk
    sampler, as the reference's ``ge_scan_sampler``.
    """
    arrs = _device_arrays(params, device)
    n = params.n
    m = int(arrs["t_qij"].shape[0])
    t_g = torch.cat([arrs["t_g_up"], arrs["t_g_dd"]])
    t_b = torch.cat([arrs["t_b_up"], arrs["t_b_dd"]])

    def init_fn(gen):
        return _stationary_state(arrs, gen)

    def sample_fn(state, gen):
        u15 = torch.randint(0, _LATTICE, (2 * n + 2 * m,), generator=gen,
                            dtype=torch.int32, device=device)
        u_gate, u_up, u_dd = u15[: n + m], u15[n + m: 2 * n + m], u15[2 * n + m:]
        state.copy_(torch.where(state, u_gate >= t_b, u_gate < t_g))
        su, sp = state[:n], state[n:]
        ups = su & (u_up < arrs["t_q_up"])
        tij = sp & (u_dd < arrs["t_qij"])
        tji = sp & ((u_dd < arrs["t_e"]) | ((u_dd >= arrs["t_qij"]) & (u_dd < arrs["t_mid"])))
        tau_dd = gather_pairs(tij, tji, arrs["pair_lane"]).reshape(n, n).float()
        return ups.float(), tau_dd, state

    return init_fn, sample_fn


def sample_ge_rounds(params: GEParams, generator: torch.Generator,
                     rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A whole GE trace on ``generator``'s device: ``(R, n)`` uplinks and
    ``(R, n, n)`` D2D, float32, the chains started from their stationary law.

    :func:`ge_scan_sampler` run ``rounds`` times, each round written into
    its row.  The same law as :func:`sample_ge_rounds_host` and the
    reference's ``sample_ge_rounds``; not their draws.
    """
    n, dev = params.n, generator.device
    init_fn, sample_fn = ge_scan_sampler(params, dev)
    state = init_fn(generator)
    ups = torch.empty((rounds, n), dtype=torch.float32, device=dev)
    dds = torch.empty((rounds, n, n), dtype=torch.float32, device=dev)
    for r in range(rounds):
        ups[r], dds[r], state = sample_fn(state, generator)
    return ups, dds


# ---------------------------------------------------------------------------
# ChannelProcess wrapper: block-wise generation, per-round service
# ---------------------------------------------------------------------------


class MarkovChannel(BlockBufferedChannel):
    """Serve a Gilbert–Elliott trace, generating ``block`` rounds at a
    time and carrying the gate chains' state across blocks.

    The chains start from their stationary law.  Randomness comes from
    one numpy ``Generator`` seeded from ``seed``; no global RNG is read.
    Within a block only the gate recurrence runs round by round; the
    conditional emissions are drawn for the whole block at once.
    """

    def __init__(self, params: GEParams, seed: int = 0, block: int = 256):
        super().__init__(params.n, block)
        self.params = params
        self._rng = np.random.default_rng(seed)
        q_up, qij, qji, e_c, iu, ju = _conditionals(params)
        self._law = dict(
            q_up=q_up, qij=qij, e_c=e_c, mid=qij + qji - e_c, iu=iu, ju=ju,
            g=np.concatenate([(1.0 - params.lam_up) * params.pi_up,
                              (1.0 - params.lam_dd) * params.pi_dd]),
            b=np.concatenate([(1.0 - params.lam_up) * (1.0 - params.pi_up),
                              (1.0 - params.lam_dd) * (1.0 - params.pi_dd)]),
        )
        # packed gate state: n uplink gates, then one per unordered pair
        pi = np.concatenate([params.pi_up, params.pi_dd])
        self._gates = self._rng.random(pi.shape[0]) < pi

    def _generate_block(self, rounds: int):
        law, n = self._law, self.n
        u_gate = self._rng.random((rounds, law["g"].shape[0]))
        gates = np.empty_like(u_gate, dtype=bool)
        s = self._gates
        for r in range(rounds):
            s = np.where(s, u_gate[r] >= law["b"], u_gate[r] < law["g"])
            gates[r] = s
        self._gates = s
        su, sp = gates[:, :n], gates[:, n:]
        ups = su & (self._rng.random((rounds, n)) < law["q_up"])
        uu = self._rng.random(sp.shape)
        tij = sp & (uu < law["qij"])
        tji = sp & ((uu < law["e_c"]) | ((uu >= law["qij"]) & (uu < law["mid"])))
        dds = np.broadcast_to(np.eye(n), (rounds, n, n)).copy()
        dds[:, law["iu"], law["ju"]] = tij
        dds[:, law["ju"], law["iu"]] = tji
        return ups.astype(np.float64), dds

    def model_for_round(self, r: int) -> LinkModel:
        return self.params.model

    def scan_sampler(self, device):
        """``(init_fn, sample_fn)`` advancing the GE chains in-scan on ``device``."""
        return ge_scan_sampler(self.params, device)

"""Clustered channels: tau_dd served in (C, m, m) block form (numpy).

The dense channels emit an (n, n) tau_dd per round, which under
clustering is mostly structural zeros (2 GiB a round at n = 2^14).  These
processes draw only the links that exist: one uniform (or one
Gilbert–Elliott gate chain) per intra-cluster pair, C·m(m-1)/2 lanes in
all, and assemble the block tensor with the dense samplers' per-pair lane
gather, ``pair_lane_table(m)`` applied per cluster (the table indexes
within a cluster, so one table serves every cluster).

The round treats tau_dd as an opaque tensor, so the block layout flows
through ``FLTrainer`` unchanged; only the ``clustered`` strategy reads
it.  :class:`ClusteredStaticChannel` is the paper's i.i.d. law restricted
to the block support; :class:`ClusteredMarkovChannel` carries one GE gate
per uplink and per intra-cluster pair with the reference's integer
thresholds on a 15-bit lattice and its marginal-preserving fit.

The port of ``repro.channel.clustered``.  The reference draws its stream
from ``jax.random``, which cannot be reproduced here, so each channel
block-generates ``block`` rounds at a time from a numpy ``Generator``
seeded from ``seed`` and agrees with the reference in law, not draw for
draw.  ``trace`` and ``tau_for_round`` read the same buffers.  The
reference's in-scan samplers belong to the chunked engine (ROADMAP.md
queue 1, item 8) and its generator state to checkpointing (item 15).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.channel.base import BlockBufferedChannel, pair_lane_table
from repro_torch.core.blocks import ClusteredLinkModel

__all__ = [
    "ClusteredGEParams",
    "gilbert_elliott_clustered",
    "ClusteredStaticChannel",
    "ClusteredMarkovChannel",
]

_EPS = 1e-12
# the reference's GE thresholds live on a 15-bit integer lattice
# (repro.channel.markov._LATTICE): probabilities quantized to 2^-15
_LATTICE = 32768


def _pair_params(model: ClusteredLinkModel):
    """Per-cluster unordered-pair marginals: (C, mp) each, mp = m(m-1)/2."""
    iu, ju = np.triu_indices(model.m, k=1)
    return model.Pb[:, iu, ju], model.Pb[:, ju, iu], model.Eb[:, iu, ju]


def _block_gather(tij: np.ndarray, tji: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """Assemble (..., C, m, m) f64 from per-pair draws ``tij``/``tji``
    (..., C, mp) through the local pair-lane table."""
    ones = np.ones((*tij.shape[:-1], 1), bool)
    cat = np.concatenate([tij, tji, ones], axis=-1)  # (..., C, 2mp+1)
    m = int(round(np.sqrt(lane.shape[0])))
    return cat[..., lane].reshape(*tij.shape[:-1], m, m).astype(np.float64)


# ---------------------------------------------------------------------------
# i.i.d. clustered sampling (the paper's law on the block support)
# ---------------------------------------------------------------------------


class ClusteredStaticChannel(BlockBufferedChannel):
    """The paper's i.i.d. channel on the block support, block-buffered.

    ``tau_for_round`` returns ``(tau_up (n,), tau_b (C, m, m))``; ``trace``
    the bulk ``(K, n)`` / ``(K, C, m, m)`` forms.  Each pair draws one
    uniform that couples ``tau_ij`` and ``tau_ji`` as the dense static
    sampler does."""

    def __init__(self, model: ClusteredLinkModel, seed: int = 0, block: int = 256):
        super().__init__(model.n, block)
        self.model = model
        self._pij, self._pji, self._e = _pair_params(model)
        self._lane = pair_lane_table(model.m)
        self._rng = np.random.default_rng(seed)

    def _generate_block(self, rounds: int):
        ups = self._rng.random((rounds, self.n)) < self.model.p
        uu = self._rng.random((rounds, *self._pij.shape))
        pij, pji, e = self._pij, self._pji, self._e
        both = uu < e
        tij = both | ((uu >= e) & (uu < pij))
        tji = both | ((uu >= pij) & (uu < pij + pji - e))
        return ups.astype(np.float64), _block_gather(tij, tji, self._lane)

    def model_for_round(self, r: int) -> ClusteredLinkModel:
        return self.model


# ---------------------------------------------------------------------------
# Gilbert–Elliott clustered chains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusteredGEParams:
    """GE chain parameters on the block support: one gate per uplink and
    per intra-cluster unordered pair (``(C, mp)``, pair index local to the
    cluster via ``np.triu_indices(m, 1)``)."""

    model: ClusteredLinkModel
    pi_up: np.ndarray   # (n,)
    lam_up: np.ndarray  # (n,)
    pi_dd: np.ndarray   # (C, mp)
    lam_dd: np.ndarray  # (C, mp)

    @property
    def n(self) -> int:
        return self.model.n


def gilbert_elliott_clustered(
    model: ClusteredLinkModel,
    memory=0.9,
    occupancy=None,
) -> ClusteredGEParams:
    """Fit per-link GE chains matching ``model``'s marginals exactly: the
    dense ``gilbert_elliott`` fit restricted to the links that exist (the
    formulas are elementwise per link, here on (C, mp) arrays)."""
    if isinstance(memory, tuple):
        lam_up_s, lam_dd_s = memory
    else:
        lam_up_s = lam_dd_s = float(memory)
    for lam in (lam_up_s, lam_dd_s):
        if not 0.0 <= lam < 1.0:
            raise ValueError(f"memory must be in [0, 1), got {lam}")

    pij, pji, eij = _pair_params(model)
    floor_up = model.p
    floor_dd = np.maximum(np.maximum(pij, pji), pij + pji - eij)
    if occupancy is None:
        pi_up, pi_dd = floor_up.copy(), floor_dd.copy()
    else:
        if not 0.0 < occupancy <= 1.0:
            raise ValueError(f"occupancy must be in (0, 1], got {occupancy}")
        pi_up = np.maximum(floor_up, occupancy)
        pi_dd = np.maximum(floor_dd, occupancy)
    pi_up = np.where(floor_up <= 0.0, 1.0, pi_up)
    pi_dd = np.where(floor_dd <= 0.0, 1.0, pi_dd)

    lam_up = np.where(pi_up >= 1.0, 0.0, np.full(model.n, lam_up_s))
    lam_dd = np.where(pi_dd >= 1.0, 0.0, np.full(pi_dd.shape, lam_dd_s))
    return ClusteredGEParams(model, pi_up, lam_up, pi_dd, lam_dd)


def _lattice(p) -> np.ndarray:
    return np.rint(np.clip(p, 0.0, 1.0) * _LATTICE).astype(np.int64)


class ClusteredMarkovChannel(BlockBufferedChannel):
    """GE bursty blockage on the block support, ``block`` rounds generated
    at a time with the gate chains' state carried across blocks.

    The chains start from their stationary law.  Each round draws 15-bit
    integers per lane and compares them with the reference's lattice
    thresholds: the gate step ``s <- u >= t_b if s else u < t_g`` runs
    round by round, the emissions for the whole block at once."""

    def __init__(self, params: ClusteredGEParams, seed: int = 0, block: int = 256):
        super().__init__(params.n, block)
        self.params = params
        model = params.model
        pij, pji, eij = _pair_params(model)
        pi_dd = np.maximum(params.pi_dd, _EPS)
        q_up = np.where(params.pi_up > 0, model.p / np.maximum(params.pi_up, _EPS), 0.0)
        qij, qji, e_c = pij / pi_dd, pji / pi_dd, eij / pi_dd
        self._t = dict(
            g=_lattice(np.concatenate([(1.0 - params.lam_up) * params.pi_up,
                                       ((1.0 - params.lam_dd) * params.pi_dd).ravel()])),
            b=_lattice(np.concatenate([(1.0 - params.lam_up) * (1.0 - params.pi_up),
                                       ((1.0 - params.lam_dd) * (1.0 - params.pi_dd)).ravel()])),
            q_up=_lattice(q_up),
            qij=_lattice(qij),
            e=_lattice(e_c),
            mid=_lattice(qij) + _lattice(qji) - _lattice(e_c),
        )
        self._lane = pair_lane_table(model.m)
        self._rng = np.random.default_rng(seed)
        # packed gate state: n uplink gates, then one per intra-cluster pair
        pi = np.concatenate([params.pi_up, params.pi_dd.ravel()])
        self._gates = self._rng.random(pi.shape[0]) < pi

    def _generate_block(self, rounds: int):
        t, n = self._t, self.n
        C, mp = self.params.pi_dd.shape
        u_gate = self._rng.integers(0, _LATTICE, (rounds, t["g"].shape[0]), dtype=np.int32)
        gates = np.empty(u_gate.shape, dtype=bool)
        s = self._gates
        for r in range(rounds):
            s = np.where(s, u_gate[r] >= t["b"], u_gate[r] < t["g"])
            gates[r] = s
        self._gates = s
        su, sp = gates[:, :n], gates[:, n:].reshape(rounds, C, mp)
        ups = su & (self._rng.integers(0, _LATTICE, (rounds, n), dtype=np.int32) < t["q_up"])
        u_dd = self._rng.integers(0, _LATTICE, (rounds, C, mp), dtype=np.int32)
        tij = sp & (u_dd < t["qij"])
        tji = sp & ((u_dd < t["e"]) | ((u_dd >= t["qij"]) & (u_dd < t["mid"])))
        return ups.astype(np.float64), _block_gather(tij, tji, self._lane)

    def model_for_round(self, r: int) -> ClusteredLinkModel:
        return self.params.model

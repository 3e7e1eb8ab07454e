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
in-scan samplers of the chunked engine's no-trace mode,
:func:`clustered_static_scan_sampler` and
:func:`clustered_ge_scan_sampler`, draw one round per call from a
``torch.Generator`` in the block layout.  Both channels checkpoint their
numpy stream (and the Markov one its gate state) through
:class:`~repro_torch.channel.base.BlockBufferedChannel`'s hooks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.channel.base import BlockBufferedChannel, gather_pairs, pair_lane_table
from repro_torch.channel.markov import _LATTICE, _lattice
from repro_torch.core.blocks import ClusteredLinkModel

__all__ = [
    "ClusteredGEParams",
    "gilbert_elliott_clustered",
    "ClusteredStaticChannel",
    "ClusteredMarkovChannel",
    "clustered_static_scan_sampler",
    "clustered_ge_scan_sampler",
]

_EPS = 1e-12


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

    def scan_sampler(self, device):
        """``(init_fn, sample_fn)`` drawing i.i.d. block rounds in-scan on ``device``."""
        return clustered_static_scan_sampler(self.model, device)


def clustered_static_scan_sampler(model: ClusteredLinkModel, device):
    """In-scan i.i.d. sampler on ``device``: ``sample_fn(state, gen) ->
    (tau_up (n,), tau_b (C, m, m), state)``, the block twin of
    :func:`repro_torch.channel.base.static_scan_sampler` with the same
    one-uniform reciprocity coupling per pair; carried state ``()``."""
    n, m = model.n, model.m
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.as_tensor(model.p, **f32)
    pij, pji, e = (torch.as_tensor(a, **f32) for a in _pair_params(model))
    lane = torch.as_tensor(pair_lane_table(m), dtype=torch.int64, device=device)

    def init_fn(gen):
        del gen
        return ()

    def sample_fn(state, gen):
        tau_up = (torch.rand(n, generator=gen, **f32) < p).float()
        uu = torch.rand(pij.shape, generator=gen, **f32)  # (C, mp)
        both = uu < e
        tij = both | ((uu >= e) & (uu < pij))
        tji = both | ((uu >= pij) & (uu < pij + pji - e))
        return tau_up, _block_emit(tij, tji, lane, m), state

    return init_fn, sample_fn


def _block_emit(tij: torch.Tensor, tji: torch.Tensor, lane: torch.Tensor, m: int):
    """(C, m, m) f32 from per-pair draws (C, mp) through the local lanes."""
    return gather_pairs(tij, tji, lane).reshape(tij.shape[0], m, m).float()


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
        # the in-scan sampler's thresholds, read on the host
        t = {k: v.numpy() for k, v in _cge_arrays(params, "cpu").items()}
        self._t = dict(
            g=np.concatenate([t["t_g_up"], t["t_g_dd"].ravel()]),
            b=np.concatenate([t["t_b_up"], t["t_b_dd"].ravel()]),
            q_up=t["t_q_up"], qij=t["t_qij"], e=t["t_e"], mid=t["t_mid"],
        )
        self._lane = t["pair_lane"]
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

    def scan_sampler(self, device):
        """``(init_fn, sample_fn)`` advancing the gates in-scan on ``device``."""
        return clustered_ge_scan_sampler(self.params, device)


def _cge_arrays(params: ClusteredGEParams, device) -> dict:
    """The reference's integer-threshold operands on the block support
    (``int32`` here, the reference's ``uint16`` values), the local
    pair-lane table and the stationary occupancies, on ``device``."""
    model = params.model
    pij, pji, eij = _pair_params(model)
    pi_dd = np.maximum(params.pi_dd, _EPS)
    q_up = np.where(params.pi_up > 0, model.p / np.maximum(params.pi_up, _EPS), 0.0)
    qij, qji, e_c = pij / pi_dd, pji / pi_dd, eij / pi_dd
    thresh = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return dict(
        t_g_up=thresh(_lattice((1.0 - params.lam_up) * params.pi_up)),
        t_b_up=thresh(_lattice((1.0 - params.lam_up) * (1.0 - params.pi_up))),
        t_g_dd=thresh(_lattice((1.0 - params.lam_dd) * params.pi_dd)),
        t_b_dd=thresh(_lattice((1.0 - params.lam_dd) * (1.0 - params.pi_dd))),
        t_q_up=thresh(_lattice(q_up)),
        t_qij=thresh(_lattice(qij)),
        t_e=thresh(_lattice(e_c)),
        t_mid=thresh(_lattice(qij) + _lattice(qji) - _lattice(e_c)),
        pair_lane=torch.as_tensor(pair_lane_table(model.m), dtype=torch.int64, device=device),
        pi_up=torch.as_tensor(params.pi_up, dtype=torch.float32, device=device),
        pi_dd=torch.as_tensor(params.pi_dd, dtype=torch.float32, device=device),
    )


def _cge_emit(arrs: dict, sp: torch.Tensor, u_dd: torch.Tensor, m: int) -> torch.Tensor:
    """Conditional pair emissions given Good gates ``sp`` (C, mp), as
    (C, m, m) blocks."""
    tij = sp & (u_dd < arrs["t_qij"])
    tji = sp & ((u_dd < arrs["t_e"]) | ((u_dd >= arrs["t_qij"]) & (u_dd < arrs["t_mid"])))
    return _block_emit(tij, tji, arrs["pair_lane"], m)


def clustered_ge_scan_sampler(params: ClusteredGEParams, device):
    """Per-round GE sampler for in-scan use on ``device``, block layout: the
    twin of :func:`repro_torch.channel.markov.ge_scan_sampler` with a
    packed ``(n + C·mp,)`` gate state, updated in place, and (C, m, m)
    emissions."""
    arrs = _cge_arrays(params, device)
    n, m = params.n, params.model.m
    C, mp = arrs["t_qij"].shape
    cm = C * mp
    t_g = torch.cat([arrs["t_g_up"], arrs["t_g_dd"].reshape(cm)])
    t_b = torch.cat([arrs["t_b_up"], arrs["t_b_dd"].reshape(cm)])
    pi = torch.cat([arrs["pi_up"], arrs["pi_dd"].reshape(cm)])

    def init_fn(gen):
        return torch.rand(pi.shape, generator=gen, dtype=torch.float32, device=device) < pi

    def sample_fn(state, gen):
        u15 = torch.randint(0, _LATTICE, (2 * n + 2 * cm,), generator=gen,
                            dtype=torch.int32, device=device)
        u_gate, u_up = u15[: n + cm], u15[n + cm: 2 * n + cm]
        u_dd = u15[2 * n + cm:].reshape(C, mp)
        state.copy_(torch.where(state, u_gate >= t_b, u_gate < t_g))
        ups = (state[:n] & (u_up < arrs["t_q_up"])).float()
        return ups, _cge_emit(arrs, state[n:].reshape(C, mp), u_dd, m), state

    return init_fn, sample_fn

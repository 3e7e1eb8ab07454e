"""Network-topology builders reproducing the paper's experimental setups.

Every builder returns a :class:`repro_torch.core.connectivity.LinkModel`.  The
paper's Section V uses three families:

* Erdős–Rényi D2D graphs with uniform per-round link probability ``p_c``
  and fully reciprocal sampling (``tau_ij = 0 <=> tau_ji = 0``), combined
  with either a single well-connected client (Fig. 2a) or heterogeneous
  uplinks (Fig. 2b).
* mmWave geometric topologies (Fig. 3/4):
  ``p = min(1, exp(-d/30 + 5.2))`` as in Akdeniz et al. [4], with either
  *permanent* thresholded D2D links ([1]'s setting) or *intermittent* D2D
  links pruned below 0.5.
* Degenerate topologies (no collaboration) recovering classical FedAvg:
  ``P = I``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .connectivity import LinkModel, reciprocity_matrix

__all__ = [
    "no_collaboration",
    "fully_connected",
    "erdos_renyi",
    "ring",
    "star_relay",
    "clustered",
    "mmwave_prob",
    "mmwave_geometric",
    "paper_fig2a",
    "paper_fig2b",
    "paper_mmwave_layout",
]

# ---------------------------------------------------------------------------
# Generic graphs
# ---------------------------------------------------------------------------


def _uniform_uplinks(n: int, p_up) -> np.ndarray:
    p = np.asarray(p_up, dtype=np.float64)
    if p.ndim == 0:
        p = np.full(n, float(p))
    if p.shape != (n,):
        raise ValueError(f"p_up must broadcast to ({n},)")
    return p


def no_collaboration(n: int, p_up) -> LinkModel:
    """Classical intermittent FedAvg: no D2D links at all (P = I)."""
    P = np.eye(n)
    return LinkModel(_uniform_uplinks(n, p_up), P, reciprocity_matrix(P, 0.0))


def fully_connected(n: int, p_up, p_c: float = 1.0, rho: float = 1.0) -> LinkModel:
    """All-pairs D2D links with per-round success ``p_c``."""
    P = np.full((n, n), float(p_c))
    np.fill_diagonal(P, 1.0)
    return LinkModel(_uniform_uplinks(n, p_up), P, reciprocity_matrix(P, rho))


def erdos_renyi(
    n: int,
    p_up,
    p_c: float,
    *,
    rho: float = 1.0,
    structural: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> LinkModel:
    """Erdős–Rényi collaboration, as in the paper's Fig. 2 experiments.

    With ``structural=False`` (paper's reading): every pair is connected by
    an *intermittent* link that is up with probability ``p_c`` each round,
    with fully reciprocal sampling (rho=1) so tau_ij = tau_ji.

    With ``structural=True``: a fixed ER graph is drawn once with edge
    probability ``p_c`` and present edges are permanent (p_ij = 1).
    """
    if structural:
        if rng is None:
            rng = np.random.default_rng(0)
        upper = rng.random((n, n)) < p_c
        adj = np.triu(upper, k=1)
        P = (adj | adj.T).astype(np.float64)
        np.fill_diagonal(P, 1.0)
        return LinkModel(_uniform_uplinks(n, p_up), P, reciprocity_matrix(P, 0.0))
    return fully_connected(n, p_up, p_c=p_c, rho=rho)


def ring(n: int, p_up, p_c: float = 1.0, rho: float = 1.0) -> LinkModel:
    P = np.eye(n)
    idx = np.arange(n)
    P[idx, (idx + 1) % n] = p_c
    P[idx, (idx - 1) % n] = p_c
    return LinkModel(_uniform_uplinks(n, p_up), P, reciprocity_matrix(P, rho))


def star_relay(n: int, p_up, hub: int = 0, p_c: float = 1.0, rho: float = 1.0) -> LinkModel:
    """All clients can reach one hub client (and vice versa)."""
    P = np.eye(n)
    P[:, hub] = p_c
    P[hub, :] = p_c
    P[hub, hub] = 1.0
    return LinkModel(_uniform_uplinks(n, p_up), P, reciprocity_matrix(P, rho))


def clustered(
    n: int,
    p_up,
    cluster_size: int,
    p_intra: float = 1.0,
    p_inter: float = 0.0,
    rho: float = 1.0,
) -> LinkModel:
    """Block-diagonal clusters — the semi-decentralized HFL-like layout."""
    cid = np.arange(n) // cluster_size
    same = cid[:, None] == cid[None, :]
    P = np.where(same, p_intra, p_inter).astype(np.float64)
    np.fill_diagonal(P, 1.0)
    return LinkModel(_uniform_uplinks(n, p_up), P, reciprocity_matrix(P, rho))


# ---------------------------------------------------------------------------
# mmWave geometric model (paper Sec. V-3, after Akdeniz et al.)
# ---------------------------------------------------------------------------


def mmwave_prob(d: np.ndarray) -> np.ndarray:
    """p = min(1, exp(-d/30 + 5.2)) with d in meters."""
    return np.minimum(1.0, np.exp(-np.asarray(d, dtype=np.float64) / 30.0 + 5.2))


def mmwave_geometric(
    positions: np.ndarray,
    ps_position: Sequence[float] = (0.0, 0.0),
    *,
    d2d_mode: str = "intermittent",
    prune_below: float = 0.5,
    permanent_threshold: float = 0.99,
    rho: float = 0.0,
) -> LinkModel:
    """Geometric mmWave topology.

    Parameters
    ----------
    positions: (n, 2) client coordinates in meters.
    d2d_mode:
        ``"intermittent"`` — Fig. 3b: keep p_ij, but drop links with
        p_ij < ``prune_below`` (too unreliable to collaborate).
        ``"permanent"``    — Fig. 3a / ISIT'22: p_ij = 1 iff
        p_ij >= ``permanent_threshold`` else 0.
    """
    pos = np.asarray(positions, dtype=np.float64)
    n = pos.shape[0]
    ps = np.asarray(ps_position, dtype=np.float64)
    d_up = np.linalg.norm(pos - ps[None, :], axis=1)
    p = mmwave_prob(d_up)
    d_dd = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=2)
    P = mmwave_prob(d_dd)
    if d2d_mode == "permanent":
        P = (P >= permanent_threshold).astype(np.float64)
    elif d2d_mode == "intermittent":
        P = np.where(P >= prune_below, P, 0.0)
    else:
        raise ValueError(f"unknown d2d_mode {d2d_mode!r}")
    np.fill_diagonal(P, 1.0)
    return LinkModel(p, P, reciprocity_matrix(P, rho))


# ---------------------------------------------------------------------------
# The paper's concrete experimental layouts
# ---------------------------------------------------------------------------


def paper_fig2a(n: int = 10, p_good: float = 0.9, p_bad: float = 0.1, p_c: float = 0.9) -> LinkModel:
    """Fig. 2a: exactly one client with good PS connectivity, ER D2D."""
    p_up = np.full(n, p_bad)
    p_up[0] = p_good
    return fully_connected(n, p_up, p_c=p_c, rho=1.0)


def paper_fig2b(p_c: float = 0.9) -> LinkModel:
    """Fig. 2b: heterogeneous uplinks (p1=p4=p5=p8=0.1, p7=0.8, p10=0.9,
    the rest 'moderate' — we use 0.4), ER D2D with probability ``p_c``."""
    p_up = np.array([0.1, 0.4, 0.4, 0.1, 0.1, 0.4, 0.8, 0.1, 0.4, 0.9])
    return fully_connected(10, p_up, p_c=p_c, rho=1.0)


def paper_mmwave_layout(
    n: int = 10,
    seed: int = 1,
    spread: float = 220.0,
    n_near: int = 3,
    **kwargs,
) -> LinkModel:
    """A layout in the spirit of Fig. 3: PS at the origin, ``n_near`` clients
    within uplink coverage, the rest spread beyond it in loose groups so that
    only D2D relaying can reach the PS."""
    rng = np.random.default_rng(seed)
    pos = np.empty((n, 2))
    # d <= 156m -> p_i = 1 at d = 156; coverage decays after ~156 m.
    near_r = 120.0 + 40.0 * rng.random(n_near)
    near_th = 2 * np.pi * rng.random(n_near)
    pos[:n_near] = np.c_[near_r * np.cos(near_th), near_r * np.sin(near_th)]
    far = n - n_near
    far_r = spread + 60.0 * rng.random(far)
    far_th = 2 * np.pi * rng.random(far)
    pos[n_near:] = np.c_[far_r * np.cos(far_th), far_r * np.sin(far_th)]
    return mmwave_geometric(pos, (0.0, 0.0), **kwargs)

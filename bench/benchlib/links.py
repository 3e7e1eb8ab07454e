"""The network a cell runs over: its link probabilities, the taus drawn from
them, and the relay weights, all made by the benchmark from the seed.

A frozen numpy copy of the paper's model (Yemini et al., arXiv:2202.11850,
Sec. II-B and Algorithm 3), so that a later change to the program's own
copy cannot move what both sides are given:

* ``p[i]`` is client i's uplink probability, ``P[i, j]`` the D2D link
  i -> j (diagonal 1), ``E[i, j] = E[tau_ij tau_ji]`` the reciprocity;
* one round draws ``tau_up (n,)`` and ``tau_dd (n, n)``, each unordered
  pair from the joint law of its two links;
* :func:`copt_alpha` is COPT-alpha: Gauss-Seidel over the columns of A on
  the convex bound Sbar, then on S, each column in closed form with its
  multiplier found by bisection (Appendix E).  ``A[j, i]`` is the weight
  client j gives client i's update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["Links", "fully_connected", "sample_round", "TauStream",
           "copt_alpha", "variance_S", "unbiasedness_residual"]


@dataclasses.dataclass(frozen=True)
class Links:
    p: np.ndarray  # (n,)
    P: np.ndarray  # (n, n), unit diagonal
    E: np.ndarray  # (n, n), symmetric

    @property
    def n(self) -> int:
        return int(self.p.shape[0])


def _reciprocity(P: np.ndarray, rho: float) -> np.ndarray:
    E = (1.0 - rho) * P * P.T + rho * np.minimum(P, P.T)
    np.fill_diagonal(E, 1.0)
    return E


def fully_connected(p_up: Sequence[float], p_c: float, rho: float) -> Links:
    """Every pair linked, each link up with probability ``p_c`` a round."""
    p = np.asarray(p_up, dtype=np.float64)
    P = np.full((p.shape[0], p.shape[0]), float(p_c))
    np.fill_diagonal(P, 1.0)
    return Links(p, P, _reciprocity(P, float(rho)))


def sample_round(links: Links, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """One round: ``tau_up[i]`` and ``tau_dd[i, j]`` (j heard i), each pair
    {i < j} from one uniform against its joint law."""
    n = links.n
    tau_up = (rng.random(n) < links.p).astype(np.float64)
    iu, ju = np.triu_indices(n, k=1)
    u = rng.random(iu.shape[0])
    pij, pji, e = links.P[iu, ju], links.P[ju, iu], links.E[iu, ju]
    both = u < e
    tau_dd = np.eye(n)
    tau_dd[iu, ju] = both | ((u >= e) & (u < pij))
    tau_dd[ju, iu] = both | ((u >= pij) & (u < pij + pji - e))
    return tau_up, tau_dd


class TauStream:
    """The taus of every round, each a function of the seed and the round
    alone, served as the program's trainer asks for them (``trace`` for a
    chunk, ``tau_for_round`` for one round).  ``model`` is what
    ``model_for_round`` returns: the program's own link type, built by the
    caller from the same arrays."""

    def __init__(self, links: Links, seed: int, model=None):
        self.links = links
        self.seed = int(seed)
        self.model = model

    @property
    def n(self) -> int:
        return self.links.n

    def tau_for_round(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        return sample_round(self.links, np.random.default_rng([self.seed, 0x7a5, int(r)]))

    def trace(self, start: int, rounds: int) -> Tuple[np.ndarray, np.ndarray]:
        ups, dds = zip(*(self.tau_for_round(start + i) for i in range(rounds)))
        return np.stack(ups), np.stack(dds)

    def model_for_round(self, r: int):
        return self.model


# ---------------------------------------------------------------------------
# COPT-alpha
# ---------------------------------------------------------------------------


def _terms(links: Links, A: np.ndarray):
    p, P, E = links.p, links.P, links.E
    q = np.einsum("ij,ji->j", P, A)
    term1 = float(np.sum(p * (1.0 - p) * q * q))
    term2 = float(np.einsum("ij,j,ij,ji->", P, p, 1.0 - P, A * A))
    return term1, term2, E - P * P.T


def variance_S(links: Links, A: np.ndarray) -> float:
    term1, term2, D = _terms(links, A)
    return term1 + term2 + float(np.einsum("i,l,il,il,li->", links.p, links.p, D, A, A))


def _variance_Sbar(links: Links, A: np.ndarray) -> float:
    term1, term2, D = _terms(links, A)
    return term1 + term2 + float(np.einsum("i,l,il,li->", links.p, links.p, D, A * A))


def unbiasedness_residual(links: Links, A: np.ndarray) -> np.ndarray:
    """Eq. (5): ``sum_j p_j p_ij alpha_ji - 1`` for every client i."""
    return np.einsum("j,ij,ji->i", links.p, links.P, A) - 1.0


def _initial(links: Links) -> np.ndarray:
    p, P, n = links.p, links.P, links.n
    mask = (p[None, :] > 0) & (P > 0)
    counts = mask.sum(axis=1).astype(np.float64)
    A = np.zeros((n, n))
    for i in range(n):
        if counts[i]:
            js = np.nonzero(mask[i])[0]
            A[js, i] = 1.0 / (counts[i] * p[js] * P[i, js])
    return A


def _column(links: Links, A: np.ndarray, i: int, fine_tune: bool) -> np.ndarray:
    p, P, E, n = links.p, links.P, links.E, links.n
    x = np.zeros(n)
    w = p * P[i, :]
    if np.max(w) <= 0.0:
        return x
    perfect = np.isclose(w, 1.0)
    if perfect.any():
        x[perfect] = 1.0 / perfect.sum()
        return x
    active = w > 0.0
    ja = np.nonzero(active)[0]
    c = np.einsum("lj,jl->j", P, A) - P[i, :] * A[:, i]
    recip = np.zeros(n)
    recip[ja] = p[i] * (E[i, ja] / P[i, ja] - P[ja, i])
    if fine_tune:
        denom = 2.0 * (1.0 - w)
        shift = 2.0 * (1.0 - p) * c + 2.0 * recip * A[i, :]
    else:
        denom = 2.0 * ((1.0 - w) + recip)
        shift = 2.0 * (1.0 - p) * c
    denom = np.where(active, denom, np.inf)

    def x_of(lam: float) -> np.ndarray:
        return np.where(active, np.maximum(lam - shift, 0.0) / denom, 0.0)

    lo = 0.0
    hi = float(np.max(shift[ja]) + np.max(denom[ja]) / np.min(w[ja])) + 1.0
    while float(np.sum(w * x_of(hi))) < 1.0:
        hi *= 2.0
        if hi > 1e18:
            raise RuntimeError("bisection failed to bracket lambda")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if float(np.sum(w * x_of(mid))) < 1.0:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-12 * max(1.0, hi):
            break
    x = x_of(hi)
    s = float(np.sum(w * x))
    return x / s if s > 0 else x


def copt_alpha(links: Links, sweeps: int, fine_tune_sweeps: int,
               tol: float = 1e-10, init: Optional[np.ndarray] = None) -> np.ndarray:
    """Algorithm 3: ``sweeps`` Gauss-Seidel sweeps on Sbar, then
    ``fine_tune_sweeps`` on S, each phase stopping once a sweep changes its
    objective by at most ``tol`` (relative)."""
    A = _initial(links) if init is None else np.asarray(init, np.float64).copy()
    for n_sweeps, fine in ((sweeps, False), (fine_tune_sweeps, True)):
        f = variance_S if fine else _variance_Sbar
        prev = f(links, A)
        for _ in range(n_sweeps):
            for i in range(links.n):
                A[:, i] = _column(links, A, i, fine)
            cur = f(links, A)
            if abs(prev - cur) <= tol * max(1.0, abs(prev)):
                break
            prev = cur
    return A

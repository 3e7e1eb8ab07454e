"""Intermittent-connectivity model of the ColRel paper (Sec. II-B), numpy.

Client *i*'s uplink to the parameter server succeeds in round r with
probability ``p_i`` (``tau_i(r) ~ Bernoulli(p_i)``), and the D2D link from
client i to client j succeeds with probability ``p_ij``
(``tau_ij(r) ~ Bernoulli(p_ij)``, ``p_ii = 1``).  Links are independent
across rounds; within a round the only admitted correlation is *channel
reciprocity* between ``tau_ij`` and ``tau_ji``, captured by
``E_{i,j} = E[tau_ij * tau_ji] >= p_ij * p_ji``.

Index conventions used throughout the code base (matching the paper):

* ``p[i]``       — uplink success probability of client i.
* ``P[i, j]``    — success probability of the D2D link i -> j
                   (client i transmitting, client j receiving).
* ``E[i, j]``    — reciprocity correlation E[tau_ij * tau_ji]  (symmetric).
* ``A[i, j]``    — alpha_ij, the weight client i applies to the update it
                   received from client j (Sec. II-C, Eq. (3)).

Sampled per-round indicators:

* ``tau_up[i]``     — realization of tau_i(r).
* ``tau_dd[i, j]``  — realization of tau_ij(r), i.e. "j successfully heard
                      i's broadcast"; the diagonal is always 1.
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = [
    "LinkModel",
    "reciprocity_matrix",
    "sample_round",
    "sample_rounds",
    "effective_weights",
]


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Static description of the intermittent network for one experiment."""

    p: np.ndarray  # (n,)   uplink success probabilities
    P: np.ndarray  # (n, n) D2D success probabilities, diag == 1
    E: np.ndarray  # (n, n) reciprocity correlations E[tau_ij tau_ji]

    def __post_init__(self) -> None:
        p = np.asarray(self.p, dtype=np.float64)
        P = np.asarray(self.P, dtype=np.float64)
        E = np.asarray(self.E, dtype=np.float64)
        n = p.shape[0]
        if p.ndim != 1:
            raise ValueError(f"p must be a vector, got shape {p.shape}")
        if P.shape != (n, n) or E.shape != (n, n):
            raise ValueError(
                f"P/E must be ({n},{n}); got {P.shape} and {E.shape}"
            )
        if np.any((p < 0) | (p > 1)) or np.any((P < 0) | (P > 1)):
            raise ValueError("probabilities must lie in [0, 1]")
        if not np.allclose(np.diag(P), 1.0):
            raise ValueError("P must have a unit diagonal (p_ii = 1)")
        if not np.allclose(E, E.T):
            raise ValueError("E must be symmetric")
        # Frechet bounds for a coupled Bernoulli pair.
        lo = np.maximum(0.0, P + P.T - 1.0)
        hi = np.minimum(P, P.T)
        if np.any(E < lo - 1e-9) or np.any(E > hi + 1e-9):
            raise ValueError("E violates the Frechet bounds for (P, P^T)")
        if np.any(E + 1e-9 < P * P.T):
            raise ValueError(
                "paper assumes E_{i,j} >= p_ij * p_ji (nonneg. reciprocity)"
            )
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "P", P)
        object.__setattr__(self, "E", E)

    @property
    def n(self) -> int:
        return int(self.p.shape[0])

    def with_reciprocity(self, rho: float) -> "LinkModel":
        return LinkModel(self.p, self.P, reciprocity_matrix(self.P, rho))

    def neighbor_counts(self) -> np.ndarray:
        """Number of clients that can ever hear client i (p_ij > 0, j != i)."""
        off = self.P - np.eye(self.n)
        return (off > 0).sum(axis=1)


def reciprocity_matrix(P: np.ndarray, rho: float) -> np.ndarray:
    """Interpolate E between independence (rho=0) and max coupling (rho=1).

    ``E = (1-rho) * p_ij p_ji + rho * min(p_ij, p_ji)`` — always inside the
    Frechet bounds and >= p_ij p_ji as the paper assumes.
    """
    if not 0.0 <= rho <= 1.0:
        raise ValueError("rho must be in [0, 1]")
    P = np.asarray(P, dtype=np.float64)
    ind = P * P.T
    full = np.minimum(P, P.T)
    E = (1.0 - rho) * ind + rho * full
    np.fill_diagonal(E, 1.0)
    return E


def sample_round(
    model: LinkModel, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Draw one round's connectivity realization.

    Returns ``(tau_up, tau_dd)``: tau_up (n,) float64 in {0,1};
    tau_dd (n,n) with tau_dd[i, j] = tau_ij(r) and unit diagonal.  The pair
    (tau_ij, tau_ji) is drawn from the joint law with marginals
    (p_ij, p_ji) and correlation E[i, j]:

        P(1,1) = E, P(1,0) = p_ij - E, P(0,1) = p_ji - E,
        P(0,0) = 1 - p_ij - p_ji + E.
    """
    n = model.n
    tau_up = (rng.random(n) < model.p).astype(np.float64)

    u = rng.random((n, n))
    u = np.triu(u, k=1)  # one uniform per unordered pair {i<j}
    tau_dd = np.eye(n)
    iu, ju = np.triu_indices(n, k=1)
    pij = model.P[iu, ju]
    pji = model.P[ju, iu]
    e = model.E[iu, ju]
    uu = u[iu, ju]
    both = uu < e
    only_ij = (uu >= e) & (uu < pij)
    only_ji = (uu >= pij) & (uu < pij + pji - e)
    tau_dd[iu, ju] = (both | only_ij).astype(np.float64)
    tau_dd[ju, iu] = (both | only_ji).astype(np.float64)
    return tau_up, tau_dd


def sample_rounds(
    model: LinkModel, rng: np.random.Generator, rounds: int
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized multi-round sampling: (R, n) uplinks and (R, n, n) D2D.

    Batched RNG — every uniform for the whole experiment is drawn in one
    call, no per-round host loop.  Distribution-identical to stacking
    :func:`sample_round` ``rounds`` times (the per-round law is the same
    coupling); the draw *order* differs, so sequences from the two APIs
    are not bit-equal for the same generator state (cross-checked
    statistically in ``tests/test_channel.py``).
    """
    n = model.n
    ups = (rng.random((rounds, n)) < model.p).astype(np.float64)
    iu, ju = np.triu_indices(n, k=1)
    u = rng.random((rounds, iu.shape[0]))  # one uniform per pair per round
    pij, pji, e = model.P[iu, ju], model.P[ju, iu], model.E[iu, ju]
    both = u < e
    only_ij = (u >= e) & (u < pij)
    only_ji = (u >= pij) & (u < pij + pji - e)
    dds = np.zeros((rounds, n, n))
    dds[:, iu, ju] = both | only_ij
    dds[:, ju, iu] = both | only_ji
    dds += np.eye(n)[None]
    return ups, dds


# The one canonical contraction behind every "effective weights" variant:
# w_j = sum_i tau_up[i] * A[i, j] * tau_dd[j, i].  The numpy function below
# and its device twin ``repro_torch.core.relay.effective_weights`` both
# evaluate exactly this spec.
EFFECTIVE_WEIGHTS_EINSUM = "i,ij,ji->j"


def effective_weights(
    A: np.ndarray, tau_up: np.ndarray, tau_dd: np.ndarray
) -> np.ndarray:
    """Per-client effective aggregation weight for one round (exact fusion).

    The PS update (Alg. 2, line 5) is
        x^{r+1} = x^r + (1/n) sum_i tau_i * sum_j tau_ji alpha_ij Dx_j
                = x^r + (1/n) sum_j w_j Dx_j,
    with  ``w_j = sum_i tau_i * tau_ji * alpha_ij``
                = sum_i tau_up[i] * tau_dd[j, i] * A[i, j].

    This identity is what the fused "weighted-psum" execution path uses; it
    reproduces the paper-faithful PS trajectory exactly for the same draws.
    """
    # w_j = sum_i tau_up[i] * A[i, j] * tau_dd[j, i]
    return np.einsum(EFFECTIVE_WEIGHTS_EINSUM, tau_up, np.asarray(A), tau_dd)

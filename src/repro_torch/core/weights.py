"""Consensus-weight optimization (COPT-alpha, Algorithm 3 of the paper).

The PS update variance is controlled (Theorem 1) by

    S(p, P, A) =   sum_{i,j,l} p_j (1-p_j) p_ij p_lj  alpha_ji alpha_jl
                 + sum_{i,j}   p_ij p_j (1-p_ij)      alpha_ji^2
                 + sum_{i,l}   p_i p_l (E_il - p_il p_li) alpha_il alpha_li

subject to the unbiasedness condition (Eq. (5))

    sum_j p_j p_ij alpha_ji = 1            for every i,     alpha >= 0.

``S`` is non-convex due to the reciprocity cross terms; the paper first
minimizes the convex upper bound ``Sbar`` (cross terms alpha_il alpha_li
replaced by alpha_li^2), then fine-tunes ``S`` from that warm start.  Both
phases are Gauss–Seidel sweeps over the *columns* of A (column i = the
weights everyone assigns to client i's update); each column subproblem has a
closed-form KKT solution parameterized by a Lagrange multiplier found by
bisection (Appendix E).

Index conventions (see ``connectivity.py``): ``A[j, i] = alpha_ji`` is the
weight client j gives to client i's update; ``P[i, j] = p_ij`` is the i->j
link probability.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .connectivity import LinkModel

__all__ = [
    "variance_S",
    "variance_Sbar",
    "unbiasedness_residual",
    "is_unbiased",
    "initial_weights",
    "fedavg_weights",
    "optimize_weights",
    "importance_weights",
    "OptResult",
]

# ---------------------------------------------------------------------------
# The variance functionals and the unbiasedness condition
# ---------------------------------------------------------------------------


def _terms(model: LinkModel, A: np.ndarray):
    p, P, E = model.p, model.P, model.E
    A = np.asarray(A, dtype=np.float64)
    # q_j = sum_i p_ij alpha_ji  = row j of A dotted with column j of P
    q = np.einsum("ij,ji->j", P, A)
    term1 = float(np.sum(p * (1.0 - p) * q * q))
    # sum_{i,j} p_ij p_j (1 - p_ij) alpha_ji^2
    term2 = float(np.einsum("ij,j,ij,ji->", P, p, 1.0 - P, A * A))
    # reciprocity coupling, E_il - p_il p_li
    D = E - P * P.T
    return term1, term2, D, A, p


def variance_S(model: LinkModel, A: np.ndarray) -> float:
    """The exact (possibly non-convex) variance proxy S(p, P, A)."""
    term1, term2, D, A, p = _terms(model, A)
    term3 = float(np.einsum("i,l,il,il,li->", p, p, D, A, A))
    return term1 + term2 + term3


def variance_Sbar(model: LinkModel, A: np.ndarray) -> float:
    """The convex upper bound Sbar >= S (Lemma 2)."""
    term1, term2, D, A, p = _terms(model, A)
    term3 = float(np.einsum("i,l,il,li->", p, p, D, A * A))
    return term1 + term2 + term3


def unbiasedness_residual(model: LinkModel, A: np.ndarray) -> np.ndarray:
    """Per-client residual of condition (5): sum_j p_j p_ij alpha_ji - 1."""
    A = np.asarray(A, dtype=np.float64)
    # c_i = sum_j p_j * P[i, j] * A[j, i]
    return np.einsum("j,ij,ji->i", model.p, model.P, A) - 1.0


def is_unbiased(model: LinkModel, A: np.ndarray, atol: float = 1e-8) -> bool:
    return bool(np.max(np.abs(unbiasedness_residual(model, A))) <= atol)


# ---------------------------------------------------------------------------
# Baseline weight matrices
# ---------------------------------------------------------------------------


def initial_weights(model: LinkModel) -> np.ndarray:
    """Algorithm 3 line 1 initialization (feasible for (5) by construction):

        alpha_ji^(0) = 1 / (|{k : p_k p_ik > 0}| * p_j * p_ij)
                       if p_j > 0 and p_ij > 0 else 0.
    """
    p, P = model.p, model.P
    n = model.n
    mask = (p[None, :] > 0) & (P > 0)  # mask[i, j]: j can relay for i
    counts = mask.sum(axis=1).astype(np.float64)  # per column-owner i
    A = np.zeros((n, n))
    for i in range(n):
        if counts[i] == 0:
            continue  # client i is unreachable; no feasible weights exist
        js = np.nonzero(mask[i])[0]
        A[js, i] = 1.0 / (counts[i] * p[js] * P[i, js])
    return A


def fedavg_weights(n: int) -> np.ndarray:
    """No relaying: alpha_ii = 1, alpha_ij = 0 (i != j).

    Note this equals the paper's *blind FedAvg* baseline and is biased
    whenever p_i < 1 (it violates (5) unless scaled by 1/p_i)."""
    return np.eye(n)


def importance_weights(model: LinkModel) -> np.ndarray:
    """No relaying but unbiased: alpha_ii = 1 / p_i (importance sampling)."""
    with np.errstate(divide="ignore"):
        d = np.where(model.p > 0, 1.0 / np.maximum(model.p, 1e-300), 0.0)
    return np.diag(d)


# ---------------------------------------------------------------------------
# Column subproblem: closed form + bisection on lambda (Appendix E)
# ---------------------------------------------------------------------------


def _solve_column(
    model: LinkModel,
    A: np.ndarray,
    i: int,
    *,
    fine_tune: bool,
    tol: float = 1e-12,
    max_bisect: int = 200,
) -> np.ndarray:
    """Minimize over column i (variables x_j = alpha_ji) with others fixed.

    Implements Eq. (11) (convex relaxation of Sbar) when ``fine_tune`` is
    False and Eq. (14) (the S objective) when True.
    """
    p, P, E = model.p, model.P, model.E
    n = model.n
    x = np.zeros(n)

    w = p * P[i, :]  # w_j = p_j * p_ij, the constraint coefficients
    if np.max(w) <= 0.0:
        return x  # client i unreachable: infeasible column, leave zero

    # Perfect links shortcut (second case of (11)/(14)).
    perfect = np.isclose(w, 1.0)
    if perfect.any():
        x[perfect] = 1.0 / perfect.sum()
        return x

    active = w > 0.0  # j's that can carry weight for i
    ja = np.nonzero(active)[0]

    # c_j = sum_{l != i} p_lj alpha_jl  (current values of other columns)
    c = np.einsum("lj,jl->j", P, A) - P[i, :] * A[:, i]

    if not fine_tune:
        # denominators 2[(1 - p_j p_ij) + p_i (E_ij / p_ij - p_ji)]
        recip = np.zeros(n)
        recip[ja] = model.p[i] * (E[i, ja] / P[i, ja] - P[ja, i])
        denom = 2.0 * ((1.0 - w) + recip)
        shift = 2.0 * (1.0 - p) * c
    else:
        recip = np.zeros(n)
        recip[ja] = model.p[i] * (E[i, ja] / P[i, ja] - P[ja, i])
        denom = 2.0 * (1.0 - w)
        # extra cross term with the (fixed) reverse weights alpha_ij = A[i, j]
        shift = 2.0 * (1.0 - p) * c + 2.0 * recip * A[i, :]

    denom = np.where(active, denom, np.inf)

    def x_of(lam: float) -> np.ndarray:
        v = np.where(active, np.maximum(lam - shift, 0.0) / denom, 0.0)
        return v

    def g(lam: float) -> float:
        return float(np.sum(w * x_of(lam)))

    # Bisection for g(lam) = 1.  g is nondecreasing, g(0) may be 0.
    lo = 0.0
    hi = float(np.max(shift[ja]) + np.max(denom[ja]) / np.min(w[ja])) + 1.0
    while g(hi) < 1.0:
        hi *= 2.0
        if hi > 1e18:
            raise RuntimeError("bisection failed to bracket lambda")
    for _ in range(max_bisect):
        mid = 0.5 * (lo + hi)
        if g(mid) < 1.0:
            lo = mid
        else:
            hi = mid
        if hi - lo <= tol * max(1.0, hi):
            break
    x = x_of(hi)
    s = float(np.sum(w * x))
    if s > 0:
        x = x / s  # exact feasibility (removes residual bisection error)
    return x


# ---------------------------------------------------------------------------
# Algorithm 3 (COPT-alpha)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OptResult:
    A: np.ndarray
    S: float
    Sbar: float
    S_init: float
    history: list  # (phase, sweep, S value) tuples
    converged: bool


def optimize_weights(
    model: LinkModel,
    *,
    sweeps: int = 50,
    fine_tune_sweeps: int = 50,
    tol: float = 1e-10,
    init: Optional[np.ndarray] = None,
    callback: Optional[Callable[[str, int, float], None]] = None,
) -> OptResult:
    """COPT-alpha: Gauss–Seidel on Sbar, then fine-tune S (Algorithm 3).

    One "sweep" updates every column once (the paper's iteration counter
    ``ell`` advances one column at a time; ``sweeps`` = ell / n).
    """
    A = initial_weights(model) if init is None else np.asarray(init, float).copy()
    S_init = variance_S(model, A)
    history: list = []
    converged = False

    def _phase(n_sweeps: int, fine_tune: bool, tag: str, A: np.ndarray):
        nonlocal converged
        f = variance_S if fine_tune else variance_Sbar
        prev = f(model, A)
        for s in range(n_sweeps):
            for i in range(model.n):
                A[:, i] = _solve_column(model, A, i, fine_tune=fine_tune)
            cur = f(model, A)
            history.append((tag, s, cur))
            if callback is not None:
                callback(tag, s, cur)
            if abs(prev - cur) <= tol * max(1.0, abs(prev)):
                converged = True
                return A
            prev = cur
        return A

    A = _phase(sweeps, fine_tune=False, tag="relax", A=A)
    A = _phase(fine_tune_sweeps, fine_tune=True, tag="fine", A=A)
    return OptResult(
        A=A,
        S=variance_S(model, A),
        Sbar=variance_Sbar(model, A),
        S_init=S_init,
        history=history,
        converged=converged,
    )

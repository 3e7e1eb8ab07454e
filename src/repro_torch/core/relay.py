"""The collaborative-relaying consensus operation (paper Eq. (3)) on tensors.

Two mathematically equivalent execution paths:

* **Faithful** (Alg. 1 lines 8-11 + Alg. 2 line 5): materialize each
  client's relayed consensus ``Dx~_i = sum_j tau_ji alpha_ij Dx_j``, then
  the PS adds ``(1/n) sum_i tau_i Dx~_i``.
* **Fused** (exact): collapse both stages into the effective per-client
  weights ``w_j = sum_i tau_i tau_ji alpha_ij`` and one weighted reduction.

Everything here operates on stacked dense updates ``(n, d)``.
"""

from __future__ import annotations

import torch

from repro_torch.core import connectivity

__all__ = [
    "mixing_matrix",
    "relay_mix",
    "ps_aggregate",
    "effective_weights",
    "fused_round_delta",
    "colrel_round_delta",
]


def mixing_matrix(A: torch.Tensor, tau_dd: torch.Tensor) -> torch.Tensor:
    """M[i, j] = alpha_ij * tau_ji — the realized consensus matrix;
    ``tau_dd[j, i]`` is the indicator that j's broadcast reached i."""
    return A * tau_dd.T


def relay_mix(updates: torch.Tensor, A: torch.Tensor, tau_dd: torch.Tensor) -> torch.Tensor:
    """Faithful local consensus: (n, d) -> (n, d), Dx~ = (A * tau_dd^T) Dx."""
    M = mixing_matrix(A.to(updates.dtype), tau_dd.to(updates.dtype))
    return M @ updates


def ps_aggregate(updates_tilde: torch.Tensor, tau_up: torch.Tensor) -> torch.Tensor:
    """Blind PS sum (Alg. 2 line 5, without the +x^(r)): (1/n) sum_i tau_i Dx~_i."""
    n = updates_tilde.shape[0]
    return (tau_up.to(updates_tilde.dtype) @ updates_tilde) / n


def effective_weights(A: torch.Tensor, tau_up: torch.Tensor,
                      tau_dd: torch.Tensor) -> torch.Tensor:
    """w_j = sum_i tau_i tau_ji alpha_ij, through the same contraction spec
    as the numpy :func:`repro_torch.core.connectivity.effective_weights`."""
    return torch.einsum(connectivity.EFFECTIVE_WEIGHTS_EINSUM, tau_up, A, tau_dd)


def fused_round_delta(updates: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(1/n) sum_j w_j Dx_j — the fused relay+aggregate reduction."""
    n = updates.shape[0]
    return (w.to(updates.dtype) @ updates) / n


def colrel_round_delta(updates: torch.Tensor, A: torch.Tensor, tau_up: torch.Tensor,
                       tau_dd: torch.Tensor, *, fused: bool = False) -> torch.Tensor:
    """End-to-end ColRel round delta applied by the PS: (d,) from (n, d)."""
    if fused:
        w = effective_weights(A.float(), tau_up.float(), tau_dd.float())
        return fused_round_delta(updates, w)
    tilde = relay_mix(updates, A, tau_dd)
    return ps_aggregate(tilde, tau_up)

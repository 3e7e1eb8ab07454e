"""Block-sparse clustered connectivity: the population-scale representation.

Under clustering (C clusters of m clients, relaying within a cluster and
nothing across) the mixing matrix is block-diagonal, so this module keeps
only the C diagonal blocks, ``(C, m, m)`` instead of ``(n, n)``, for the
link statistics, the relay weights and the per-round tau_dd realizations:
memory and flops drop from O(n²) to O(C·m²) = O(n·m).

Index conventions are those of :mod:`repro_torch.core.connectivity`
restricted to a cluster: ``Pb[c, i, j]`` is the D2D success probability
from the cluster's i-th to its j-th client (global ids ``c*m + i`` ->
``c*m + j``), ``Ab[c, i, j] = alpha_{c*m+i, c*m+j}`` and ``tau_b[c, i, j]``
realizes the intra-cluster link i -> j.  Cross-cluster links are absent
(p = 0), so the block form is lossless for clustered topologies.

The host side (numpy: :class:`ClusterSpec`, :class:`ClusteredLinkModel`
and the dense round trips) is copied from ``repro.core.blocks``; the
tensor ops are the blocked twins of :mod:`repro_torch.core.relay`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .connectivity import LinkModel

__all__ = [
    "ClusterSpec",
    "ClusteredLinkModel",
    "block_diag_from_blocks",
    "blocks_from_dense",
    "block_mixing_matrix",
    "block_relay_mix",
    "block_effective_weights",
    "block_ps_aggregate",
    "block_colrel_round_delta",
]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """C clusters of m clients each; client i lives in cluster i // m."""

    n: int
    m: int  # cluster size

    def __post_init__(self) -> None:
        if self.m <= 0 or self.n <= 0:
            raise ValueError(f"need positive n, m (got n={self.n}, m={self.m})")
        if self.n % self.m != 0:
            raise ValueError(
                f"cluster size m={self.m} must divide n={self.n} "
                "(pad the population or pick a divisor)"
            )

    @property
    def C(self) -> int:
        return self.n // self.m


# ---------------------------------------------------------------------------
# dense <-> block conversions (host-side, numpy)
# ---------------------------------------------------------------------------


def blocks_from_dense(X: np.ndarray, spec: ClusterSpec, *,
                      strict: bool = True, atol: float = 0.0) -> np.ndarray:
    """Extract the C diagonal (m, m) blocks of an (n, n) matrix.

    ``strict=True`` refuses matrices with mass outside the diagonal
    blocks (the block form would silently drop it).
    """
    X = np.asarray(X)
    n, m, C = spec.n, spec.m, spec.C
    if X.shape != (n, n):
        raise ValueError(f"expected ({n}, {n}), got {X.shape}")
    Xb = X.reshape(C, m, C, m)
    blocks = np.ascontiguousarray(np.einsum("cidj->cdij", Xb).diagonal(
        axis1=0, axis2=1).transpose(2, 0, 1))
    if strict:
        off = X - block_diag_from_blocks(blocks, spec)
        if np.max(np.abs(off)) > atol:
            raise ValueError(
                "matrix has mass outside the diagonal blocks; the "
                f"(C={C}, m={m}) block form would drop it"
            )
    return blocks


def block_diag_from_blocks(blocks: np.ndarray, spec: ClusterSpec) -> np.ndarray:
    """Scatter (C, m, m) blocks onto a dense block-diagonal (n, n)."""
    blocks = np.asarray(blocks)
    n, m, C = spec.n, spec.m, spec.C
    if blocks.shape != (C, m, m):
        raise ValueError(f"expected ({C}, {m}, {m}), got {blocks.shape}")
    out = np.zeros((n, n), blocks.dtype)
    for c in range(C):
        out[c * m:(c + 1) * m, c * m:(c + 1) * m] = blocks[c]
    return out


@dataclasses.dataclass(frozen=True)
class ClusteredLinkModel:
    """Block-diagonal :class:`LinkModel`: only the C diagonal (m, m)
    blocks of P / E are stored; cross-cluster links are structurally
    zero, and the dense form is never built on the way in."""

    p: np.ndarray   # (n,)     uplink success probabilities
    Pb: np.ndarray  # (C, m, m) intra-cluster D2D probabilities, diag == 1
    Eb: np.ndarray  # (C, m, m) intra-cluster reciprocity correlations

    def __post_init__(self) -> None:
        p = np.asarray(self.p, dtype=np.float64)
        Pb = np.asarray(self.Pb, dtype=np.float64)
        Eb = np.asarray(self.Eb, dtype=np.float64)
        if p.ndim != 1 or Pb.ndim != 3 or Pb.shape[1] != Pb.shape[2]:
            raise ValueError(f"bad shapes p{p.shape} Pb{Pb.shape}")
        if Eb.shape != Pb.shape:
            raise ValueError(f"Eb {Eb.shape} != Pb {Pb.shape}")
        C, m, _ = Pb.shape
        if p.shape[0] != C * m:
            raise ValueError(f"p has {p.shape[0]} clients, blocks give {C * m}")
        if np.any((p < 0) | (p > 1)) or np.any((Pb < 0) | (Pb > 1)):
            raise ValueError("probabilities must lie in [0, 1]")
        if not np.allclose(Pb[:, np.arange(m), np.arange(m)], 1.0):
            raise ValueError("Pb must have unit diagonals (p_ii = 1)")
        if not np.allclose(Eb, np.swapaxes(Eb, 1, 2)):
            raise ValueError("Eb blocks must be symmetric")
        PbT = np.swapaxes(Pb, 1, 2)
        lo = np.maximum(0.0, Pb + PbT - 1.0)
        hi = np.minimum(Pb, PbT)
        if np.any(Eb < lo - 1e-9) or np.any(Eb > hi + 1e-9):
            raise ValueError("Eb violates the Frechet bounds for (Pb, Pb^T)")
        if np.any(Eb + 1e-9 < Pb * PbT):
            raise ValueError(
                "paper assumes E_{i,j} >= p_ij * p_ji (nonneg. reciprocity)"
            )
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "Pb", Pb)
        object.__setattr__(self, "Eb", Eb)

    # -- geometry -------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.p.shape[0])

    @property
    def C(self) -> int:
        return int(self.Pb.shape[0])

    @property
    def m(self) -> int:
        return int(self.Pb.shape[1])

    @property
    def spec(self) -> ClusterSpec:
        return ClusterSpec(self.n, self.m)

    # -- views ----------------------------------------------------------
    def cluster_model(self, c: int) -> LinkModel:
        """Cluster c as a standalone (m,)-client :class:`LinkModel`, the
        view per-cluster COPT-alpha optimizes over."""
        m = self.m
        return LinkModel(self.p[c * m:(c + 1) * m], self.Pb[c], self.Eb[c])

    def to_dense(self) -> LinkModel:
        """The equivalent dense model (materializes (n, n): small n only)."""
        spec = self.spec
        P = block_diag_from_blocks(self.Pb, spec)
        E = block_diag_from_blocks(self.Eb, spec)
        return LinkModel(self.p, P, E)

    @classmethod
    def from_dense(cls, model: LinkModel, cluster_size: int,
                   *, atol: float = 0.0) -> "ClusteredLinkModel":
        """Block a dense model; refuses cross-cluster mass (strict)."""
        spec = ClusterSpec(model.n, cluster_size)
        return cls(
            model.p,
            blocks_from_dense(model.P, spec, strict=True, atol=atol),
            blocks_from_dense(model.E, spec, strict=True, atol=atol),
        )


# ---------------------------------------------------------------------------
# blocked relay ops on tensors (the twins of core/relay.py)
# ---------------------------------------------------------------------------


def block_mixing_matrix(Ab: torch.Tensor, tau_b: torch.Tensor) -> torch.Tensor:
    """Per-cluster realized mixing mask: Mb[c] = Ab[c] * tau_b[c]^T."""
    return Ab * tau_b.transpose(1, 2)


def block_relay_mix(updates: torch.Tensor, Ab: torch.Tensor,
                    tau_b: torch.Tensor) -> torch.Tensor:
    """Faithful blocked consensus: (n, d) -> (n, d), per cluster
    ``Dx~_c = (Ab[c] * tau_b[c]^T) @ Dx_c``: C independent (m, m) x (m, d)
    products, never the dense (n, n) one."""
    C, m, _ = Ab.shape
    d = updates.shape[-1]
    Mb = block_mixing_matrix(Ab.to(updates.dtype), tau_b.to(updates.dtype))
    return torch.bmm(Mb, updates.reshape(C, m, d)).reshape(C * m, d)


def block_effective_weights(Ab: torch.Tensor, tau_up: torch.Tensor,
                            tau_b: torch.Tensor) -> torch.Tensor:
    """Blocked twin of :func:`repro_torch.core.relay.effective_weights`:
    ``w_j = sum_i tau_i tau_ji alpha_ij`` with i running over j's cluster.
    Returns (n,)."""
    C, m, _ = Ab.shape
    w = torch.einsum("ci,cij,cji->cj", tau_up.reshape(C, m), Ab, tau_b)
    return w.reshape(C * m)


def block_ps_aggregate(tilde_b: torch.Tensor, tau_up: torch.Tensor) -> torch.Tensor:
    """Blind PS sum over the blocked consensus: (C, m, d) -> (d,)."""
    C, m, _ = tilde_b.shape
    return torch.einsum("ci,cik->k", tau_up.reshape(C, m).to(tilde_b.dtype),
                        tilde_b) / (C * m)


def block_colrel_round_delta(updates: torch.Tensor, Ab: torch.Tensor,
                             tau_up: torch.Tensor, tau_b: torch.Tensor, *,
                             fused: bool = False) -> torch.Tensor:
    """End-to-end blocked ColRel PS delta: (d,) from (n, d) updates with
    ``(C, m, m)`` relay weights and D2D realizations."""
    C, m, _ = Ab.shape
    n = C * m
    if fused:
        w = block_effective_weights(Ab.float(), tau_up.float(), tau_b.float())
        return (w.to(updates.dtype) @ updates) / n
    tilde = block_relay_mix(updates, Ab, tau_b)
    return block_ps_aggregate(tilde.reshape(C, m, -1), tau_up)

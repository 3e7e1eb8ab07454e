"""FedDec-style multi-hop relaying (Costantini et al., arXiv:2306.06715).

ColRel gives every update one D2D broadcast slot before the uplink; with
K relay slots an update can travel K hops, so clients with no direct path
to a well-connected relay still reach the PS through intermediate
neighbours.  Each hop re-applies the round's realized masked mixing
matrix ``M = A * tau_dd^T`` (block realizations persist across the
round's K broadcast slots — the channel-coherence-time assumption; the
``hop_mixing`` hook is where per-slot re-draws would plug in), so the
consensus the PS hears is ``tau_up @ M^K @ updates``.

Every hop is linear, so the K-hop scheme collapses onto per-client scalar
weights ``w = tau_up @ M^K``: the strategy has both the multi-stage
dense-stack path (:meth:`MultiHopStrategy.aggregate`) and the scalar
collapse (:meth:`MultiHopStrategy.weights`), and at K=1 the collapse is
bitwise colrel's.

Unbiasedness correction: COPT-alpha's condition (5) makes the one-hop
expected weight ``E[w_j] = 1``; after K hops that no longer holds
(weights compound through intermediate links).  ``calibrate`` estimates
``c_j = E[(tau_up @ M^K)_j]`` by Monte Carlo over the link model and
rescales each source client by ``1 / (n c_j)``, restoring
``E[w_j] = 1/n`` per client — the K-hop analogue of (5).

The port of ``repro.strategies.multihop``: :func:`multihop_correction` is
the reference's numpy over the port's ``sample_rounds``, so one seed gives
the reference's correction bit for bit; the round's paths are plain
PyTorch (the reference has no Pallas kernel for them either).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import relay as relay_ops
from repro_torch.core.connectivity import LinkModel, sample_rounds
from repro_torch.strategies import registry
from repro_torch.strategies.base import AggregationStrategy, State

__all__ = ["MultiHopStrategy", "multihop_correction"]


def multihop_correction(model: LinkModel, A: np.ndarray, hops: int, *, draws: int = 4096,
                        seed: int = 0) -> np.ndarray:
    """Monte-Carlo estimate of ``c_j = E[(tau_up @ M^K)_j]`` (n,).

    Host numpy; deterministic for a fixed seed.  Clients whose expected
    weight is ~0 (unreachable through any K-hop path) keep ``c_j = 1``: no
    rescaling can make an unreachable client unbiased.
    """
    A = np.asarray(A, np.float64)
    rng = np.random.default_rng(seed)
    ups, dds = sample_rounds(model, rng, draws)  # (R, n), (R, n, n)
    M = A[None] * np.swapaxes(dds, 1, 2)  # (R, n, n) realized mixing
    w = ups
    for _ in range(int(hops)):
        w = np.einsum("ri,rij->rj", w, M)
    c = w.mean(axis=0)
    return np.where(c > 1e-6, c, 1.0)


class MultiHopStrategy(AggregationStrategy):
    """K-hop relay mixing with an optional unbiasedness correction."""

    name = "multihop"
    needs_A = True
    scalar_collapsible = True

    def __init__(self, hops: int = 2, correction=None):
        if int(hops) < 1:
            raise ValueError(f"hops must be >= 1, got {hops}")
        self.hops = int(hops)
        #: (n,) Monte-Carlo E[tau_up @ M^K] in f32; None = uncorrected
        self.correction = (None if correction is None
                           else np.asarray(correction, dtype=np.float32))
        # device -> the (n,) source scale 1 / (n c), made on the first round
        # on that device, which runs eagerly, so a captured round only reads it
        self._scales: Dict[torch.device, torch.Tensor] = {}

    @property
    def calibration_tracks_A(self) -> bool:
        # the correction is E[tau @ M^K] for one alpha; an adaptive A swap
        # would leave it stale
        return self.correction is not None

    def calibrate(self, model: LinkModel, A) -> "MultiHopStrategy":
        if self.correction is not None:
            return self
        return MultiHopStrategy(self.hops,
                                correction=multihop_correction(model, A, self.hops))

    def hop_mixing(self, k: int, M: torch.Tensor, tau_dd: torch.Tensor) -> torch.Tensor:
        """Mixing matrix applied at hop ``k`` (0-indexed).  The default
        reuses the round's realized mask every slot; subclasses can re-mask
        per hop when per-slot tau draws are available."""
        del k, tau_dd
        return M

    def _scale(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """``x`` (leading axis the n source clients) times the source scale:
        ``/ n`` uncorrected (colrel's arithmetic), else ``* 1 / (n c)``."""
        if self.correction is None:
            return x / n
        scale = self._scales.get(x.device)
        if scale is None:
            c = torch.as_tensor(self.correction).to(x.device)
            scale = self._scales[x.device] = 1.0 / (n * c)
        return x * (scale if x.dim() == 1 else scale[:, None])

    def weights(self, tau_up, tau_dd, A):
        n = tau_up.shape[0]
        Af, td = A.float(), tau_dd.float()
        # hop 1 through the shared effective-weights contraction: at K=1
        # this is colrel's collapse
        w = relay_ops.effective_weights(Af, tau_up.float(), td)
        M = relay_ops.mixing_matrix(Af, td)
        for k in range(1, self.hops):
            w = w @ self.hop_mixing(k, M, td)
        return self._scale(w, n)

    def aggregate(self, updates, tau_up, tau_dd, A, state: State = ()):
        """Multi-stage dense-stack path: K successive relay broadcasts over
        the realized links, then the blind PS sum."""
        n = updates.shape[0]
        x = self._scale(updates.float(), n)
        M = relay_ops.mixing_matrix(A.float(), tau_dd.float())
        for k in range(self.hops):
            x = self.hop_mixing(k, M, tau_dd) @ x  # broadcast slot k
        return tau_up.float() @ x, state

    def __repr__(self) -> str:
        return (f"MultiHopStrategy(hops={self.hops}, "
                f"calibrated={self.correction is not None})")


registry.register("multihop", MultiHopStrategy)

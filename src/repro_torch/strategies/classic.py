"""The paper's ColRel and its FedAvg baselines.

ColRel's ``fused`` option picks how the same delta is computed:

* ``fused=False`` — faithful two-stage path (Alg. 1 lines 8-11 + Alg. 2
  line 5): relay mix across the client axis, then the blind PS sum, per
  tree leaf.
* ``fused="collapse"`` (or ``True``) — exact scalar collapse onto the
  effective weights ``w_j = sum_i tau_i tau_ji alpha_ij``, per leaf.
* ``fused="kernel"`` — flatten once and stream the ``(n, d)`` stack
  through the fused aggregation kernel in one pass; with
  ``ctx.use_segments(d)`` the per-leaf ``(n, d_i)`` segments stream
  through one launch of the row kernel against one collapsed weight row
  instead.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import flatten
from repro_torch.core import relay as relay_ops
from repro_torch.kernels import ops as kernel_ops
from repro_torch.strategies import registry
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext, State

__all__ = ["ColRelStrategy", "FedAvgPerfect", "FedAvgBlind", "FedAvgNonBlind"]

_FUSED_MODES = (False, True, "collapse", "kernel")


class ColRelStrategy(AggregationStrategy):
    """The paper's collaborative relaying (Sec. II-C / Eq. (3))."""

    name = "colrel"
    needs_A = True
    scalar_collapsible = True

    def __init__(self, fused: "bool | str" = False):
        if fused not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES}, got {fused!r}")
        self.fused = "collapse" if fused is True else fused

    def weights(self, tau_up, tau_dd, A):
        n = tau_up.shape[0]
        w = relay_ops.effective_weights(A.float(), tau_up.float(), tau_dd.float())
        return w / n

    def aggregate(self, updates, tau_up, tau_dd, A, state: State = ()):
        delta = relay_ops.colrel_round_delta(updates, A, tau_up, tau_dd,
                                             fused=bool(self.fused))
        return delta, state

    def aggregate_tree(self, deltas, tau_up, tau_dd, A, state, ctx: ExecutionContext):
        if self.fused == "kernel":
            spec = flatten.flat_spec(deltas, stacked=True)
            if ctx.use_segments(spec.d):
                # segment streaming: collapse the weight row once and stream
                # the (n, d_i) leaf segments through one kernel launch; the
                # leaves are views of its (d,) delta
                w = kernel_ops.collapsed_weight_row(A, tau_up, tau_dd)
                segments = flatten.ravel_stacked_segments(deltas, dtype=ctx.flat_dtype)
                gflat = kernel_ops.row_stream_segments(w, segments, block_d=ctx.fused_block_d)
                return flatten.unravel(spec, gflat, dtype=torch.float32), state
            stack = flatten.ravel_stacked(deltas, dtype=ctx.flat_dtype)
            gflat = kernel_ops.fused_aggregate(A, tau_up, tau_dd, stack,
                                               block_d=ctx.fused_block_d)
            return flatten.unravel(spec, gflat, dtype=torch.float32), state
        if self.fused:  # "collapse": leaf-wise scalar weighting
            return super().aggregate_tree(deltas, tau_up, tau_dd, A, state, ctx)
        # faithful two-stage path, leaf-wise
        M = relay_ops.mixing_matrix(A.float(), tau_dd.float())
        t = tau_up.float()
        gdelta = tree.map(
            lambda D: torch.tensordot(t, torch.tensordot(M, D, dims=1), dims=1) / ctx.n_clients,
            deltas)
        return gdelta, state


class FedAvgPerfect(AggregationStrategy):
    """Upper bound: everyone always arrives."""

    name = "fedavg_perfect"
    scalar_collapsible = True

    def weights(self, tau_up, tau_dd, A):
        n = tau_up.shape[0]
        return torch.ones(n, dtype=torch.float32, device=tau_up.device) / n

    def aggregate(self, updates, tau_up, tau_dd, A, state: State = ()):
        return torch.mean(updates, dim=0), state


class FedAvgBlind(AggregationStrategy):
    """Sum of arrivals / n (OAC-style); biased whenever p_i < 1."""

    name = "fedavg_blind"
    scalar_collapsible = True

    def weights(self, tau_up, tau_dd, A):
        return tau_up.float() / tau_up.shape[0]

    def aggregate(self, updates, tau_up, tau_dd, A, state: State = ()):
        return (tau_up.to(updates.dtype) @ updates) / updates.shape[0], state


class FedAvgNonBlind(AggregationStrategy):
    """Sum of arrivals / #arrivals."""

    name = "fedavg_nonblind"
    scalar_collapsible = True

    def weights(self, tau_up, tau_dd, A):
        t = tau_up.float()
        return t / torch.clamp(torch.sum(t), min=1.0)

    def aggregate(self, updates, tau_up, tau_dd, A, state: State = ()):
        t = tau_up.to(updates.dtype)
        return (t @ updates) / torch.clamp(torch.sum(t), min=1.0), state


registry.register("colrel", ColRelStrategy)
registry.register("fedavg_perfect", FedAvgPerfect)
registry.register("fedavg_blind", FedAvgBlind)
registry.register("fedavg_nonblind", FedAvgNonBlind)
registry.register_deprecated_alias(
    "colrel_fused",
    "colrel",
    "Aggregation.COLREL_FUSED is deprecated; use "
    "strategies.get('colrel', fused=True) instead",
    fused="collapse",
)

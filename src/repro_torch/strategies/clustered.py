"""Block-sparse clustered ColRel: the population-scale strategy.

The same math as ``colrel`` restricted to a block-diagonal mixing matrix
(:mod:`repro_torch.core.blocks`): clients relay only within their
cluster, so the strategy takes the relay weights and the D2D realizations
in block form, ``A`` and ``tau_dd`` as ``(C, m, m)`` tensors.  The round
passes those arguments through without reading their shapes, so only the
strategy and the channel (:mod:`repro_torch.channel.clustered`) agree on
the layout.  A clustered run is built by handing ``FLTrainer`` a
clustered channel and the ``(C, m, m)`` weights of
:func:`repro_torch.core.weights.optimize_weights_clustered`.

Execution options mirror ``ColRelStrategy``:

* ``fused=False`` — faithful two-stage path, per tree leaf: per-cluster
  relay mix, then the blind PS sum.
* ``fused="collapse"`` (or ``True``) — exact scalar collapse onto the
  blocked effective weights, per leaf.
* ``fused="kernel"`` — flatten once and stream the ``(n, d)`` stack
  through the blocked aggregation kernel in one pass; with
  ``ctx.use_segments(d)`` each per-leaf ``(n, d_i)`` segment streams
  through the blocked row kernel against the ``(C, m)`` rows collapsed
  once instead.

With C = 1 the kernel and segment paths are ``colrel``'s to the bit.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import blocks as block_ops
from repro_torch.core import flatten
from repro_torch.kernels import ops as kernel_ops
from repro_torch.strategies import registry
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext, State

__all__ = ["ClusteredColRelStrategy"]

_FUSED_MODES = (False, True, "collapse", "kernel")


def _clusters(A: torch.Tensor):
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(
            f"the clustered strategy takes (C, m, m) block relay weights and D2D "
            f"realizations (a clustered channel and optimize_weights_clustered), "
            f"got A of shape {tuple(A.shape)}")
    return A.shape[0], A.shape[1]


class ClusteredColRelStrategy(AggregationStrategy):
    """ColRel over C independent clusters; A / tau_dd are (C, m, m)."""

    name = "clustered"
    needs_A = True
    scalar_collapsible = True

    def __init__(self, fused: "bool | str" = False):
        if fused not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES}, got {fused!r}")
        self.fused = "collapse" if fused is True else fused

    def weights(self, tau_up, tau_dd, A):
        _clusters(A)
        w = block_ops.block_effective_weights(A.float(), tau_up.float(), tau_dd.float())
        return w / tau_up.shape[0]

    def aggregate(self, updates, tau_up, tau_dd, A, state: State = ()):
        _clusters(A)
        delta = block_ops.block_colrel_round_delta(updates, A, tau_up, tau_dd,
                                                   fused=bool(self.fused))
        return delta, state

    def aggregate_tree(self, deltas, tau_up, tau_dd, A, state, ctx: ExecutionContext):
        C, m = _clusters(A)
        if self.fused == "kernel":
            spec = flatten.flat_spec(deltas, stacked=True)
            if ctx.use_segments(spec.d):
                # segment streaming: collapse the per-cluster weight rows
                # once, stream each (n, d_i) leaf segment through its own
                # blocked pass and reshape each partial delta to its leaf
                w = kernel_ops.block_collapsed_weight_row(A, tau_up, tau_dd)
                segments = flatten.ravel_stacked_segments(deltas, dtype=ctx.flat_dtype)
                leaves = [kernel_ops.block_row_stream(w, seg, block_d=ctx.fused_block_d)
                          .reshape(shape) for seg, shape in zip(segments, spec.shapes)]
                return tree.unflatten(spec.treedef, leaves), state
            stack = flatten.ravel_stacked(deltas, dtype=ctx.flat_dtype)
            gflat = kernel_ops.block_fused_aggregate(A, tau_up, tau_dd, stack,
                                                     block_d=ctx.fused_block_d)
            return flatten.unravel(spec, gflat, dtype=torch.float32), state
        if self.fused:  # "collapse": leaf-wise scalar weighting
            return super().aggregate_tree(deltas, tau_up, tau_dd, A, state, ctx)
        # faithful two-stage path, leaf-wise: per-cluster relay mix, then the
        # blind PS sum
        Mb = block_ops.block_mixing_matrix(A.float(), tau_dd.float())
        t = tau_up.float().reshape(C, m)
        gdelta = tree.map(
            lambda D: torch.einsum(
                "ci,ci...->...", t,
                torch.einsum("cij,cj...->ci...", Mb, D.reshape(C, m, *D.shape[1:])))
            / ctx.n_clients,
            deltas)
        return gdelta, state


registry.register("clustered", ClusteredColRelStrategy)

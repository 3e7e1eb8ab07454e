"""The aggregation-strategy protocol.

A strategy answers one question per round: *given the stacked client
updates and the realized connectivity, what delta does the PS apply?*
It exposes up to three representations, from most to least collapsed:

* ``weights(tau_up, tau_dd, A) -> (n,)`` — the scalar collapse, when
  ``scalar_collapsible``: ``delta = w @ updates``.  The round logs its
  sum as ``weight_sum``.
* ``aggregate(updates, tau_up, tau_dd, A, state) -> (delta, state)`` —
  the dense-stack path on the flattened ``(n, d)`` update buffer.
* ``aggregate_tree(deltas, ..., ctx) -> (gdelta, state)`` — the tree
  entry the ``per_client`` round calls, with stacked leaves ``(n, ...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core import flatten

__all__ = ["AggregationStrategy", "ExecutionContext"]

State = Any


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """How the round executes the aggregation; the same strategy gives the
    same trajectory under any context."""

    n_clients: int
    flat_dtype: torch.dtype = torch.float32  # dtype of the raveled (n, d) stack
    fused_block_d: int = 2048  # columns each CUDA block of the kernels covers
    #: flat-dim threshold for segment streaming: at ``d >= segment_d`` the
    #: kernel-fused strategies consume per-leaf (n, d_i) segments instead of
    #: the monolithic (n, d) stack; 0 keeps the monolithic path.
    segment_d: int = 0

    def use_segments(self, d: int) -> bool:
        """Whether the segment-streaming path engages for flat dim ``d``."""
        return 0 < self.segment_d <= d


class AggregationStrategy:
    """Base class for PS aggregation schemes."""

    #: registry key; set by subclasses
    name: str = "base"
    #: whether the scheme reads the relay weight matrix ``A``
    needs_A: bool = False
    #: whether ``weights`` is available (delta == w @ updates exactly)
    scalar_collapsible: bool = False

    def init_state(self, n: int, d: int, *, device=None) -> State:
        """Initial carried state for ``n`` clients and flat dim ``d``, with
        any tensors on ``device``."""
        return ()

    def wire_bits_per_coord(self, d: int) -> float:
        """Uplink wire cost per update coordinate: uncoded f32."""
        del d
        return 32.0

    def weights(self, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                A: torch.Tensor) -> Optional[torch.Tensor]:
        """Scalar collapse: (n,) weights with ``delta = w @ updates``, or
        None when the scheme does not collapse."""
        del tau_up, tau_dd, A
        return None

    def aggregate(self, updates: torch.Tensor, tau_up: torch.Tensor,
                  tau_dd: torch.Tensor, A: torch.Tensor,
                  state: State = ()) -> Tuple[torch.Tensor, State]:
        """Dense-stack path: ``(n, d)`` updates -> ``(d,)`` delta."""
        w = self.weights(tau_up, tau_dd, A)
        if w is None:
            raise NotImplementedError(
                f"{type(self).__name__} must implement aggregate() "
                "(it is not scalar-collapsible)")
        return w.to(updates.dtype) @ updates, state

    def aggregate_tree(self, deltas, tau_up: torch.Tensor, tau_dd: torch.Tensor,
                       A: torch.Tensor, state: State,
                       ctx: ExecutionContext) -> Tuple[Any, State]:
        """Tree path for stacked per-client update trees (leading axis
        ``n``): leaf-wise scalar weighting when collapsible, else the
        flatten-once dense-stack path through :meth:`aggregate`."""
        w = self.weights(tau_up, tau_dd, A)
        if w is not None:
            return tree.map(lambda D: torch.tensordot(w, D, dims=1), deltas), state
        spec = flatten.flat_spec(deltas, stacked=True)
        stack = flatten.ravel_stacked(deltas, dtype=ctx.flat_dtype)
        gflat, state = self.aggregate(stack, tau_up, tau_dd, A, state)
        return flatten.unravel(spec, gflat, dtype=torch.float32), state

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"

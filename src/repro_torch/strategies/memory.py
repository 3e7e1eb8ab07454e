"""Memory-based implicit gossiping (Xiang et al., arXiv:2404.10091): the
port of ``repro.strategies.memory``.

Under bursty blockage the same clients vanish for many consecutive
rounds, and plain FedAvg drops their updates.  The memory scheme carries
an ``(n, d)`` f32 buffer of each client's *last delivered* consensus: a
blocked uplink replays the stale contribution, so every client enters
every PS average with weight ``1/n``.  Round recursion (PS side)::

    tilde   = (A * tau_dd^T) @ updates          # ColRel D2D consensus
    contrib = tau_up * tilde + (1 - tau_up) * buffer
    delta   = (1/n) sum_i contrib_i
    buffer' = contrib                            # changes only on arrival

With every link up (``tau ≡ 1``) the buffer is never read and the round
is exactly ColRel.

Execution: ``fused=False`` (default) is the faithful path — relay mix,
select, accumulate as separate PyTorch ops (the oracle) on the flattened
stack.  ``fused="kernel"`` runs the recursion through one pass of
:func:`repro_torch.kernels.ops.fused_memory_update`, which keeps
``tilde`` out of device memory; with ``ctx.use_segments(d)`` the realized
mask is built once a round and the per-leaf ``(n, d_i)`` segments go
through one launch of :func:`repro_torch.kernels.ops.memory_stream_segments`,
so the monolithic stack never exists.

**The carried buffer is updated in place on the kernel paths.**  Where
the reference writes each contrib segment back into the donated buffer
with ``dynamic_update_slice``, the kernels write ``contrib`` straight into
the buffer (each segment into its columns) and the strategy returns
the same tensor as the next state.  A caller that keeps an earlier state
clones it first.
"""

from __future__ import annotations

import torch

from repro_torch.core import flatten
from repro_torch.core import relay as relay_ops
from repro_torch.kernels import ops as kernel_ops
from repro_torch.strategies import registry
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext, State

__all__ = ["MemoryStrategy"]

_FUSED_MODES = (False, "kernel")


class MemoryStrategy(AggregationStrategy):
    """Implicit gossip: blocked links replay the last received update."""

    name = "memory"
    needs_A = True
    scalar_collapsible = False  # stale replay cannot collapse to weights
    stateful = True

    def __init__(self, fused: "bool | str" = False):
        if fused not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES}, got {fused!r}")
        self.fused = fused

    def init_state(self, n: int, d: int, *, device=None) -> torch.Tensor:
        # zeros: a client blocked since round 0 contributes nothing until
        # its first delivery, then is always represented
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    def aggregate(self, updates, tau_up, tau_dd, A, state: State):
        n = updates.shape[0]
        tilde = relay_ops.relay_mix(updates.float(), A.float(), tau_dd.float())
        t = tau_up.float()[:, None]
        contrib = t * tilde + (1.0 - t) * state
        delta = torch.ones(n, dtype=torch.float32, device=updates.device) @ contrib / n
        return delta, contrib

    def aggregate_tree(self, deltas, tau_up, tau_dd, A, state, ctx: ExecutionContext):
        if self.fused != "kernel":
            return super().aggregate_tree(deltas, tau_up, tau_dd, A, state, ctx)
        spec = flatten.flat_spec(deltas, stacked=True)
        if ctx.use_segments(spec.d):
            # the realized mask once, then one launch over the leaf segments
            # that writes their contrib into the buffer's columns in place
            mix = kernel_ops.mixing_mask(A, tau_dd)
            segments = flatten.ravel_stacked_segments(deltas, dtype=torch.float32)
            gflat, state = kernel_ops.memory_stream_segments(mix, tau_up, segments, state,
                                                             block_d=ctx.fused_block_d)
            return flatten.unravel(spec, gflat, dtype=torch.float32), state
        stack = flatten.ravel_stacked(deltas, dtype=torch.float32)
        gflat, state = kernel_ops.fused_memory_update(A, tau_up, tau_dd, stack, state,
                                                      block_d=ctx.fused_block_d)
        return flatten.unravel(spec, gflat, dtype=torch.float32), state


registry.register("memory", MemoryStrategy)

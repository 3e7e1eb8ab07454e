"""One federated round on tensors (Algorithms 1 + 2 of the paper).

1. every client runs ``T`` local SGD steps from the PS model (Alg. 1, 1-7);
2. clients exchange updates over the sampled D2D links and each transmits
   a weighted consensus to the PS (Alg. 1, 8-11 / Eq. (3));
3. the PS applies the round's aggregation strategy and the server
   optimizer (global momentum in the paper's experiments).

Only the ``per_client`` mode is ported: it materializes the per-client
update stack.  The reference vmaps over clients; here the clients run in
a plain loop and their deltas are stacked on a new leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.core import flatten
from repro_torch.optim import Optimizer, global_norm
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext

Params = Any

StrategySpec = Union[str, AggregationStrategy]

# ROADMAP.md items that bring the reference's other round modes
UNPORTED_MODES = {
    "client_sequential": "queue 1, item 19 (other round modes)",
    "weighted_grad": "queue 1, item 19 (other round modes)",
    "weighted_flat": "queue 1, item 19 (other round modes)",
    "async": "queue 1, item 13 (async relaying)",
}


def check_mode(mode: str) -> None:
    if mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"round mode {mode!r} is not ported to repro_torch yet: "
            f"ROADMAP.md {UNPORTED_MODES[mode]}")
    if mode != "per_client":
        raise ValueError(f"unknown mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    n_clients: int
    local_steps: int  # the paper's T
    mode: str = "per_client"
    aggregation: StrategySpec = "colrel"
    # dtype of the flattened (n, d) update stack; accumulation is f32 either way
    flat_dtype: str = "float32"
    # columns each CUDA block of the aggregation kernels covers
    fused_block_d: int = 2048
    # flat-dim threshold for segment-streaming aggregation; 0 = monolithic
    segment_d: int = 0

    def __post_init__(self):
        check_mode(self.mode)

    def resolve_strategy(self) -> AggregationStrategy:
        return strategy_registry.resolve(self.aggregation)

    def execution_context(self) -> ExecutionContext:
        return ExecutionContext(
            n_clients=self.n_clients,
            flat_dtype=getattr(torch, self.flat_dtype),
            fused_block_d=self.fused_block_d,
            segment_d=self.segment_d,
        )


def _local_sgd(loss_fn: Callable, client_opt: Optimizer, params: Params,
               batches: Dict[str, torch.Tensor]) -> Tuple[Params, torch.Tensor]:
    """T local SGD steps from ``params``; ``batches`` leaves have leading
    dim T.  Returns the f32 delta ``p_T - p_0`` and the mean step loss."""
    T = next(iter(batches.values())).shape[0]
    p, ostate = params, client_opt.init(params)
    losses = []
    for t in range(T):
        p = tree.map(lambda x: x.detach().requires_grad_(), p)
        leaves, treedef = tree.flatten(p)
        loss, _ = loss_fn(p, {k: v[t] for k, v in batches.items()})
        grads = tree.unflatten(treedef, list(torch.autograd.grad(loss, leaves)))
        upd, ostate = client_opt.update(grads, ostate, p)
        with torch.no_grad():
            p = tree.map(lambda x, u: (x.float() + u).to(x.dtype), p, upd)
        losses.append(loss.detach())
    delta = tree.map(lambda a, b: a.detach().float() - b.float(), p, params)
    return delta, torch.mean(torch.stack(losses))


def make_round_fn(loss_fn: Callable, client_opt: Optimizer, server_opt: Optimizer,
                  rc: RoundConfig):
    """Returns ``round(params, server_state, agg_state, batches, tau_up,
    tau_dd, A) -> (params, server_state, agg_state, metrics)``.

    ``batches``: dict with leaves ``(n_clients, T, B, ...)`` on the
    params' device.  ``metrics`` holds 0-d tensors under the reference's
    keys: ``loss``, ``delta_norm``, ``participation``, ``uplink_bits``,
    ``weight_sum``.
    """
    strategy = rc.resolve_strategy()
    ctx = rc.execution_context()

    def round_fn(params, server_state, agg_state, batches, tau_up, tau_dd, A):
        # realized scalar weights (for ColRel the exact collapse
        # w_j = sum_i tau_i tau_ji alpha_ij / n), logged as weight_sum
        w_scalar = strategy.weights(tau_up, tau_dd, A)
        deltas, losses = [], []
        for i in range(rc.n_clients):
            delta, loss = _local_sgd(loss_fn, client_opt, params,
                                     {k: v[i] for k, v in batches.items()})
            deltas.append(delta)
            losses.append(loss)
        stacked = tree.map(lambda *ds: torch.stack(ds), *deltas)
        del deltas
        with torch.no_grad():
            gdelta, agg_state = strategy.aggregate_tree(
                stacked, tau_up, tau_dd, A, agg_state, ctx)
            # the PS feeds the negative delta to the server optimizer as a
            # pseudo-gradient; with sgd_momentum(1, beta) this is exactly
            # the paper's PS momentum
            pseudo = tree.map(lambda d: -d, gdelta)
            upd, server_state = server_opt.update(pseudo, server_state, params)
            new_params = tree.map(lambda p, u: (p.float() + u).to(p.dtype), params, upd)
            participation = torch.sum(tau_up.float())
            d_flat = flatten.flat_spec(params).d
            bits_per_client = float(d_flat * strategy.wire_bits_per_coord(d_flat))
            metrics = {
                "loss": torch.mean(torch.stack(losses)),
                "delta_norm": global_norm(gdelta),
                "participation": participation,
                "uplink_bits": participation * bits_per_client,
                "weight_sum": (torch.sum(w_scalar) if w_scalar is not None
                               else torch.tensor(float("nan"), device=tau_up.device)),
            }
        return new_params, server_state, agg_state, metrics

    return round_fn

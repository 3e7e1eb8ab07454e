"""Host-side FL training driver: samples connectivity, streams per-client
batches to the device, runs the round, tracks metrics, evaluates.

The per-round loop of ``repro.fl.trainer.FLTrainer``.  Options of the
reference that this package does not have yet raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
Prefer building a trainer through
:func:`repro_torch.fl.experiment.build_experiment`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.channel.base import StaticChannel
from repro_torch.core import flatten
from repro_torch.core.connectivity import LinkModel
from repro_torch.data.pipeline import ClientDataset, stack_chunk_batches
from repro_torch.fl.round import RoundConfig, make_round_fn
from repro_torch.optim import Optimizer

Params = Any

__all__ = ["TrainLog", "FLTrainer", "resolve_device", "unported"]

_METRIC_FIELDS = (("loss", "loss"), ("participation", "participation"),
                  ("uplink_bits", "uplink_bits"), ("weight_sum", "weight_sums"))


def unported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to repro_torch yet: ROADMAP.md queue 1, {item}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; nothing quietly carries on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; repro_torch runs on the CUDA device by "
            "default. Pass device='cpu' to run on the CPU.")
    return torch.device("cuda")


@dataclasses.dataclass
class TrainLog:
    """Per-round metric streams, under the reference's field names."""

    rounds: List[int] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    eval_rounds: List[int] = dataclasses.field(default_factory=list)
    eval_metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    participation: List[float] = dataclasses.field(default_factory=list)
    uplink_bits: List[float] = dataclasses.field(default_factory=list)
    weight_sums: List[float] = dataclasses.field(default_factory=list)
    reopt_rounds: List[int] = dataclasses.field(default_factory=list)
    est_p_err: List[float] = dataclasses.field(default_factory=list)
    S_est: List[float] = dataclasses.field(default_factory=list)
    S_true: List[float] = dataclasses.field(default_factory=list)

    def to_dict(self):
        return dataclasses.asdict(self)


class FLTrainer:
    """Runs ColRel or a FedAvg baseline over an intermittent network."""

    def __init__(
        self,
        loss_fn: Callable,
        init_params: Params,
        link_model: Optional[LinkModel],
        A: np.ndarray,
        clients: Sequence[ClientDataset],
        client_opt: Optimizer,
        server_opt: Optimizer,
        *,
        local_steps: int = 8,
        strategy: "str | strategy_registry.AggregationStrategy" = "colrel",
        mode: str = "per_client",
        seed: int = 0,
        eval_fn: Optional[Callable[[Params], Dict[str, float]]] = None,
        channel=None,
        adaptive=None,
        telemetry: bool = False,
        segment_d: int = 0,
        device=None,
    ):
        if adaptive is not None:
            raise unported("adaptive alpha re-optimization", "item 21 (adaptive alpha)")
        if telemetry:
            raise unported("telemetry", "item 14 (telemetry)")
        self.device = resolve_device(device)
        self.strategy = strategy_registry.resolve(strategy)
        if channel is None:
            if link_model is None:
                raise ValueError("provide link_model or channel")
            channel = StaticChannel(link_model, seed=seed)
        self.channel = channel
        n = channel.n
        if link_model is not None and link_model.n != n:
            raise ValueError(f"link_model.n={link_model.n} != channel.n={n}")
        if len(clients) != n:
            raise ValueError(f"{len(clients)} client datasets for {n} clients")
        self.link_model = link_model if link_model is not None else channel.model_for_round(0)
        self.A = torch.as_tensor(np.asarray(A), dtype=torch.float32, device=self.device)
        self.clients = list(clients)
        self.params = tree.map(lambda p: p.detach().to(self.device), init_params)
        self.eval_fn = eval_fn
        self.rc = RoundConfig(n_clients=n, local_steps=local_steps, mode=mode,
                              aggregation=self.strategy, segment_d=int(segment_d))
        self.server_state = server_opt.init(self.params)
        self.agg_state = self.strategy.init_state(n, flatten.flat_spec(self.params).d,
                                                  device=self.device)
        self._round_fn = make_round_fn(loss_fn, client_opt, server_opt, self.rc)
        self.round = 0
        self.log = TrainLog()

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _run_one(self, r: int, eval_every: int, verbose: bool) -> None:
        """One communication round."""
        tau_up, tau_dd = self.channel.tau_for_round(r)
        batches = stack_chunk_batches(self.clients, self.rc.local_steps, 1)
        batches = {k: self._to_device(v[0]) for k, v in batches.items()}
        (self.params, self.server_state, self.agg_state, metrics) = self._round_fn(
            self.params, self.server_state, self.agg_state, batches,
            self._to_device(tau_up, torch.float32), self._to_device(tau_dd, torch.float32),
            self.A)
        # one device->host copy for the round's scalars, widened to float64
        values = torch.stack([metrics[k] for k, _ in _METRIC_FIELDS]).cpu().double().tolist()
        self.log.rounds.append(r)
        for (_, field), v in zip(_METRIC_FIELDS, values):
            getattr(self.log, field).append(v)
        if eval_every and (r + 1) % eval_every == 0 and self.eval_fn is not None:
            em = {k: float(v) for k, v in self.eval_fn(self.params).items()}
            self.log.eval_rounds.append(r)
            self.log.eval_metrics.append(em)
            if verbose:
                print(f"  round {r+1:4d}  loss={self.log.loss[-1]:.4f}  " +
                      "  ".join(f"{k}={v:.4f}" for k, v in em.items()))
        elif verbose and (r + 1) % 10 == 0:
            print(f"  round {r+1:4d}  loss={self.log.loss[-1]:.4f}")
        self.round = r + 1

    def run(self, rounds: int, *, chunk: int = 1, eval_every: int = 0,
            verbose: bool = False) -> TrainLog:
        """Train for ``rounds`` communication rounds, one round at a time."""
        if chunk > 1:
            raise unported(f"chunk={chunk} (the chunked multi-round engine)",
                           "item 8 (chunked engine)")
        for r in range(self.round, self.round + rounds):
            self._run_one(r, eval_every, verbose)
        return self.log

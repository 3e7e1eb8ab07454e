"""Host-side FL training driver: samples connectivity, streams per-client
batches to the device, runs the round, tracks metrics, evaluates.

The per-round loop and the chunked engine of ``repro.fl.trainer.FLTrainer``.
``run(rounds, chunk=K)`` runs aligned chunks of K rounds through
:func:`~repro_torch.fl.round.make_scan_round_fn` (a captured round replayed
K times on the CUDA device): the chunk's batches come from one
``stack_chunk_batches`` and one host-to-device copy, its taus from one
``channel.trace``, and its metrics back with one device-to-host copy.  The
trajectory is bitwise the per-round loop's: both consume the same channel
and batch streams through the same round body.  ``no_trace=True`` draws the
taus inside the round from the channel's ``scan_sampler``.
``mode="async"`` (or an async strategy such as ``"async_colrel"``) runs
staleness-weighted async relaying through
:func:`~repro_torch.fl.round.make_async_round_fn` and its chunked twin.
With an :class:`~repro_torch.channel.AdaptiveWeightSchedule` attached the
trainer does not assume oracle link knowledge: it estimates ``(p, P, E)``
from the realized taus and re-runs COPT-alpha every K rounds, swapping
the fresh alpha in as a new ``A`` tensor that the next round (or the next
chunk, which copies ``A`` into its captured round's static buffer) reads.
Options of the reference that this package does not have yet raise
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
from repro_torch.core.weights import variance_S
from repro_torch.data.pipeline import ClientDataset, stack_chunk_batches
from repro_torch.fl.round import (
    RoundConfig,
    make_async_round_fn,
    make_async_scan_round_fn,
    make_round_fn,
    make_scan_round_fn,
)
from repro_torch.optim import Optimizer

Params = Any

__all__ = ["TrainLog", "FLTrainer", "resolve_device", "unported"]

# round metric -> its TrainLog field; the others (delta_norm, the async
# staleness metrics) are kept in FLTrainer.round_metrics, as the
# reference keeps them in its round events
_LOG_FIELDS = {"loss": "loss", "participation": "participation",
               "uplink_bits": "uplink_bits", "weight_sum": "weight_sums"}


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
        async_options: Optional[Dict[str, Any]] = None,
        donate: bool = True,
        segment_d: int = 0,
        device=None,
    ):
        """``mode="async"`` wraps a sync ``strategy`` in
        :class:`~repro_torch.strategies.AsyncRelayStrategy` with
        ``async_options`` (``gamma``, ``opportunistic``) and runs it as
        ``per_client``; an async strategy runs async in any case.

        ``donate=True`` (the reference's default) lets the round write the
        carry in place: the chunked engine returns its static buffers and
        overwrites them on the next chunk, and the memory strategy's kernel
        paths and the segmented async path update their buffers in place.
        So ``params``, ``server_state`` or ``agg_state`` read from the
        trainer may change under the next round.  ``donate=False`` keeps
        them: each round gets clones of the strategy state, and the
        trainer keeps clones of the carry a chunk returns."""
        if telemetry:
            raise unported("telemetry", "item 14 (telemetry)")
        self.device = resolve_device(device)
        self.strategy = strategy_registry.resolve(strategy)
        if mode == "async":
            if getattr(self.strategy, "is_async", False):
                if async_options:
                    raise ValueError("strategy is already async; pass gamma/opportunistic "
                                     "through the strategy spec, not async_options")
            else:
                self.strategy = strategy_registry.AsyncRelayStrategy(
                    inner=self.strategy, **dict(async_options or {}))
            mode = "per_client"
        elif async_options:
            raise ValueError("async_options requires mode='async'")
        self.async_mode = getattr(self.strategy, "is_async", False)
        self.donate = bool(donate)
        if channel is None:
            if link_model is None:
                raise ValueError("provide link_model or channel")
            channel = StaticChannel(link_model, seed=seed)
        self.channel = channel
        self.adaptive = adaptive
        if adaptive is not None and not self.strategy.needs_A:
            raise ValueError(
                f"adaptive alpha re-optimization only affects strategies "
                f"that read A; {self.strategy.name!r} ignores it")
        if adaptive is not None and self.strategy.calibration_tracks_A:
            raise ValueError(
                f"strategy {self.strategy.name!r} was calibrated against a "
                "fixed alpha; the adaptive schedule swaps alpha mid-run, "
                "which would silently stale the calibration — run it "
                "uncalibrated or without adaptive")
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
        make_fn = make_async_round_fn if self.async_mode else make_round_fn
        self._make_scan_fn = make_async_scan_round_fn if self.async_mode else make_scan_round_fn
        self._round_fn = make_fn(loss_fn, client_opt, server_opt, self.rc)
        self._opts = (loss_fn, client_opt, server_opt)
        self._scan_fn = None  # built on the first chunked run
        # no-trace mode: the in-scan sampler's engine and its carry
        self._seed = seed
        self._sampled_scan_fn = None
        self._channel_state = None
        self._channel_gen = None
        self.round = 0
        self.log = TrainLog()
        #: every metric the round returns, by its key, one float a round
        self.round_metrics: Dict[str, List[float]] = {}

    def _own(self, carry):
        """``carry`` as the trainer keeps it: itself, or with ``donate=False``
        clones of its tensors, which no later round writes."""
        if self.donate:
            return carry
        return tree.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, carry)

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _stack_batches(self, rounds: int) -> Dict[str, torch.Tensor]:
        """``rounds`` rounds of every client's local-step batches on the
        device, ``(rounds, n, T, B, ...)``, or ``(rounds, n, B, ...)`` for
        ``weighted_grad`` (its T = 1 collapse: the first step's batch; the
        clients' streams still draw all T, as the reference's): one gather
        per client and one host-to-device copy per leaf."""
        out = stack_chunk_batches(self.clients, self.rc.local_steps, rounds)
        if self.rc.mode == "weighted_grad":
            out = {k: np.ascontiguousarray(v[:, :, 0]) for k, v in out.items()}
        return {k: self._to_device(v) for k, v in out.items()}

    def _log_rounds(self, r: int, metrics: Dict[str, torch.Tensor]) -> None:
        """Append rounds ``r, r+1, ...`` from 0-d or ``(K,)`` metrics, with
        one device-to-host copy, widened to float64."""
        keys = list(metrics)
        values = torch.stack([metrics[k].reshape(-1) for k in keys]).cpu().double().tolist()
        self.log.rounds.extend(range(r, r + len(values[0])))
        for k, v in zip(keys, values):
            self.round_metrics.setdefault(k, []).extend(v)
            if k in _LOG_FIELDS:
                getattr(self.log, _LOG_FIELDS[k]).extend(v)

    def _maybe_eval(self, r: int, eval_every: int, verbose: bool) -> None:
        if eval_every and (r + 1) % eval_every == 0 and self.eval_fn is not None:
            em = {k: float(v) for k, v in self.eval_fn(self.params).items()}
            self.log.eval_rounds.append(r)
            self.log.eval_metrics.append(em)
            if verbose:
                print(f"  round {r+1:4d}  loss={self.log.loss[-1]:.4f}  " +
                      "  ".join(f"{k}={v:.4f}" for k, v in em.items()))
        elif verbose and (r + 1) % 10 == 0:
            print(f"  round {r+1:4d}  loss={self.log.loss[-1]:.4f}")

    def _run_one(self, r: int, eval_every: int, verbose: bool) -> None:
        """One communication round."""
        tau_up, tau_dd = self.channel.tau_for_round(r)
        batches = {k: v[0] for k, v in self._stack_batches(1).items()}
        (self.params, self.server_state, self.agg_state, metrics) = self._round_fn(
            self.params, self.server_state, self._own(self.agg_state), batches,
            self._to_device(tau_up, torch.float32), self._to_device(tau_dd, torch.float32),
            self.A)
        self._log_rounds(r, metrics)
        if self.adaptive is not None:
            self._ingest_adaptive(r, tau_up, tau_dd, verbose)
        self._maybe_eval(r, eval_every, verbose)
        self.round = r + 1

    def _ingest_adaptive(self, r: int, tau_up: np.ndarray, tau_dd: np.ndarray,
                         verbose: bool) -> bool:
        """Feed one round's realization to the adaptive schedule; on re-opt
        rounds log the event and swap in the fresh alpha as a new tensor (a
        chunk in flight may still read the old one)."""
        A_new = self.adaptive.step(r, tau_up, tau_dd)
        if A_new is None:
            return False
        self.A = torch.as_tensor(np.asarray(A_new), dtype=torch.float32).to(self.device)
        true_m = self.channel.model_for_round(r)
        info = self.adaptive.events[-1]
        self.log.reopt_rounds.append(r)
        self.log.est_p_err.append(self.adaptive.estimator.errors(true_m)["p"])
        self.log.S_est.append(float(info["S_est"]))
        self.log.S_true.append(float(variance_S(true_m, A_new)))
        if verbose:
            print(f"  round {r+1:4d}  re-opt alpha: S_est={self.log.S_est[-1]:.3f} "
                  f"S_true={self.log.S_true[-1]:.3f} p_err={self.log.est_p_err[-1]:.3f}")
        return True

    def _effective_chunk(self, chunk: int, eval_every: int) -> int:
        """The requested chunk when it divides every host-side cadence (the
        adaptive re-opt and the eval), so those events land on chunk
        boundaries, else 1 (per-round)."""
        if chunk <= 1:
            return 1
        if self.adaptive is not None and self.adaptive.cfg.every % chunk != 0:
            return 1
        if eval_every and eval_every % chunk != 0:
            return 1
        return chunk

    def _run_chunks(self, r0: int, n_chunks: int, k: int, eval_every: int,
                    verbose: bool) -> None:
        """``n_chunks`` chunks of ``k`` rounds through the chunked engine."""
        if self._scan_fn is None:
            self._scan_fn = self._make_scan_fn(*self._opts, self.rc)
        batches = self._stack_batches(k)
        for c in range(n_chunks):
            r = r0 + c * k
            tau_up, tau_dd = self.channel.trace(r, k)
            *carry, metrics = self._scan_fn(
                self.params, self.server_state, self.agg_state, batches,
                self._to_device(tau_up, torch.float32), self._to_device(tau_dd, torch.float32),
                self.A)
            self.params, self.server_state, self.agg_state = self._own(tuple(carry))
            # the chunk runs on the device while the host stacks the next
            # chunk's batches (the same client streams, in the same order)
            batches = self._stack_batches(k) if c + 1 < n_chunks else None
            self._log_rounds(r, metrics)
            if self.adaptive is not None:
                for i in range(k):
                    swapped = self._ingest_adaptive(r + i, tau_up[i], tau_dd[i], verbose)
                    if swapped and i != k - 1:  # guarded by _effective_chunk
                        raise RuntimeError(
                            f"adaptive re-opt fired mid-chunk (round {r + i}, chunk "
                            f"[{r}, {r + k})); the cadence must be a multiple of chunk")
            self._maybe_eval(r + k - 1, eval_every, verbose)
            self.round = r + k

    def _run_chunks_sampled(self, r0: int, k: int, eval_every: int, verbose: bool) -> None:
        """One chunk of ``k`` rounds whose taus are drawn inside the round by
        the channel's in-scan sampler, from a generator seeded from the
        trainer's ``seed`` on the device: no tau tensor crosses from the
        host."""
        if self._sampled_scan_fn is None:
            init_fn, sample_fn = self.channel.scan_sampler(self.device)
            self._sampled_scan_fn = self._make_scan_fn(*self._opts, self.rc,
                                                       channel_sampler=sample_fn)
            self._channel_gen = torch.Generator(device=self.device).manual_seed(self._seed)
            self._channel_state = init_fn(self._channel_gen)
        *carry, self._channel_gen, metrics = self._sampled_scan_fn(
            self.params, self.server_state, self.agg_state, self._stack_batches(k),
            self._channel_state, self._channel_gen, self.A)
        (self.params, self.server_state, self.agg_state,
         self._channel_state) = self._own(tuple(carry))
        self._log_rounds(r0, metrics)
        self._maybe_eval(r0 + k - 1, eval_every, verbose)
        self.round = r0 + k

    def run(self, rounds: int, *, chunk: int = 1, eval_every: int = 0,
            verbose: bool = False, no_trace: bool = False) -> TrainLog:
        """Train for ``rounds`` communication rounds.

        ``chunk=K`` runs K rounds per call of the chunked engine (on the
        CUDA device, K replays of one captured round) and reaches the host
        only at chunk boundaries; the trajectory is bitwise the per-round
        loop's.  Rounds that cannot form an aligned chunk (leading rounds
        until the round counter is a multiple of K, and the tail) run per
        round; if K does not divide ``eval_every`` or the adaptive
        schedule's cadence, the whole run is per round.

        ``no_trace=True`` draws the taus inside the round through the
        channel's ``scan_sampler``, in chunks of K (the last one shorter):
        the same law as the traced stream, not the same draws.  It needs a
        channel with a ``scan_sampler`` and no adaptive schedule.
        """
        start, end = self.round, self.round + rounds
        k = self._effective_chunk(int(chunk), eval_every)
        if no_trace:
            if not hasattr(self.channel, "scan_sampler"):
                raise ValueError(f"no_trace needs a channel with scan_sampler(); "
                                 f"{type(self.channel).__name__} cannot sample in-scan")
            if self.adaptive is not None:
                raise ValueError(
                    "no_trace is incompatible with adaptive re-optimization: the estimator "
                    "consumes realized taus on the host, which no_trace never materializes")
            for r in range(start, end, k):
                self._run_chunks_sampled(r, min(k, end - r), eval_every, verbose)
            return self.log
        r = start
        while r < end:
            if k > 1 and r % k == 0 and r + k <= end:
                n_chunks = (end - r) // k
                self._run_chunks(r, n_chunks, k, eval_every, verbose)
                r += n_chunks * k
            else:
                self._run_one(r, eval_every, verbose)
                r += 1
        return self.log

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
Prefer building a trainer through
:func:`repro_torch.fl.experiment.build_experiment`.

**Telemetry**: every metric stream of both paths goes through one
:class:`~repro_torch.telemetry.MetricsLogger` append path, with the
:class:`TrainLog` facade attached (``trainer.log is trainer.metrics.log``).
``telemetry=True`` runs the instrumented round (per-client participation
and bits-on-air vectors, the device-resident outage-streak carry, the
unbiasedness drift), and ``profile=`` / ``run(log_every=)`` give the
``torch.profiler`` window and the throughput readout.  Off by default; the
default path's streams are unchanged to the bit.

**Checkpoint/resume**: ``run(ckpt_dir=..., ckpt_every=..., resume_from=...)``
saves the complete run state at round or chunk boundaries through a
background writer and continues a restored run bitwise;
``save_checkpoint`` / ``restore`` do the same by hand.
"""

from __future__ import annotations

import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.channel.base import StaticChannel
from repro_torch.ckpt.schema import capture_run_state, restore_run_state, rng_state_to_json
from repro_torch.ckpt.writer import AsyncCheckpointer, CheckpointWriter, read_state, write_state
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
from repro_torch.telemetry import (
    CompileTracker,
    MetricsLogger,
    ProfileWindow,
    ThroughputMeter,
    TrainLog,
    init_streak,
)

Params = Any

__all__ = ["TrainLog", "FLTrainer", "resolve_device"]


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
        strategy: "str | strategy_registry.AggregationStrategy | None" = None,
        aggregation: "str | strategy_registry.AggregationStrategy | None" = None,
        mode: str = "per_client",
        use_fused_kernel: bool = False,
        seed: int = 0,
        eval_fn: Optional[Callable[[Params], Dict[str, float]]] = None,
        channel=None,
        adaptive=None,
        telemetry: bool = False,
        metrics: Optional[MetricsLogger] = None,
        profile: Optional[ProfileWindow] = None,
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
        trainer keeps clones of the carry a chunk returns.

        ``telemetry=True`` runs the instrumented round; ``metrics`` is the
        logger every stream goes through (a facade-only one by default) and
        ``profile`` an optional :class:`~repro_torch.telemetry.ProfileWindow`."""
        self.device = resolve_device(device)
        if strategy is not None and aggregation is not None:
            raise ValueError("pass strategy= or aggregation=, not both")
        spec = strategy if strategy is not None else (
            aggregation if aggregation is not None else "colrel")
        self.strategy = strategy_registry.resolve(spec, fused_kernel=use_fused_kernel)
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
        self.telemetry = bool(telemetry)
        self.metrics = metrics if metrics is not None else MetricsLogger()
        self.log = self.metrics.log
        self.profile = profile
        self.meter = ThroughputMeter()
        self.compiles = CompileTracker()
        self._warm_fns: set = set()
        self._streak = init_streak(n, self.device) if self.telemetry else None
        self._log_every = 0
        self._last_tlog = 0
        make_fn = make_async_round_fn if self.async_mode else make_round_fn
        self._make_scan_fn = make_async_scan_round_fn if self.async_mode else make_scan_round_fn
        self._round_fn = make_fn(loss_fn, client_opt, server_opt, self.rc,
                                 telemetry=self.telemetry)
        self._opts = (loss_fn, client_opt, server_opt)
        self._scan_fn = None  # built on the first chunked run
        # no-trace mode: the in-scan sampler's engine and its carry
        self._seed = seed
        self._sampled_scan_fn = None
        self._channel_state = None
        self._channel_gen = None
        # checkpoint/resume: the round counter, the clients' stream states at
        # the consumed-round boundary (the chunked engine stacks the next
        # chunk's batches past it), and the writer of the current run
        self.round = 0
        self._data_rng_snapshot: Optional[List[str]] = None
        self._ckpt: Optional[AsyncCheckpointer] = None
        self._ckpt_every = 0
        self._ckpt_last = -1
        #: one dict a periodic or final save: ``step``, ``block_s`` (the
        #: loop's seconds in capture and snapshot), ``snapshot_s``, and once
        #: committed ``commit_s`` (the writer thread's) and ``bytes``
        self.ckpt_records: List[Dict[str, Any]] = []

    @property
    def round_metrics(self) -> Dict[str, List[float]]:
        """Every scalar metric the round returns, by its key, one float a round."""
        return self.metrics.round_metrics

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

    # -- checkpoint/resume -------------------------------------------------
    def _client_rng_states(self) -> List[str]:
        """The clients' data-stream states at the consumed-round boundary:
        the snapshot ``_run_chunks`` takes before it stacks the next chunk's
        batches, or the live states."""
        if self._data_rng_snapshot is not None:
            return list(self._data_rng_snapshot)
        return [rng_state_to_json(c._rng) for c in self.clients]

    def save_checkpoint(self, path) -> pathlib.Path:
        """Write the complete run state to one file, synchronously."""
        write_state(path, capture_run_state(self))
        return pathlib.Path(path)

    def restore(self, source) -> int:
        """Restore from a checkpoint file or directory (its latest step) into
        a trainer assembled like the checkpointed one; returns the restored
        round counter."""
        p = pathlib.Path(source)
        state = CheckpointWriter(p).load() if p.is_dir() else read_state(p)
        restore_run_state(self, state)
        return self.round

    def _save_async(self) -> None:
        t0 = time.perf_counter()
        record = self._ckpt.save(self.round, capture_run_state(self))
        record["block_s"] = time.perf_counter() - t0
        self.ckpt_records.append(record)
        self._ckpt_last = self.round

    def _saves_at(self, r: int) -> bool:
        """Whether the boundary before round ``r`` takes a periodic save."""
        return (self._ckpt is not None and self._ckpt_every > 0
                and r % self._ckpt_every == 0 and r != self._ckpt_last)

    def _maybe_ckpt(self) -> None:
        """Periodic save at a round or chunk boundary."""
        if self._saves_at(self.round):
            self._save_async()

    def _finish_ckpt(self) -> None:
        """End of run: commit a final checkpoint, drain, stop the writer."""
        if self._ckpt is None:
            return
        try:
            if self.round != self._ckpt_last:
                self._save_async()
            self._ckpt.wait()
        finally:
            self._ckpt.close()
            self._ckpt = None

    # -- metrics -------------------------------------------------------------
    def _log_compile_growth(self, r: int) -> None:
        """``health.recompile`` for captures of an engine past its first."""
        fresh = {}
        for name, growth in self.compiles.check().items():
            if name in self._warm_fns:
                fresh[name] = growth
            else:
                self._warm_fns.add(name)
        if fresh:
            self.metrics.log_recompiles(fresh, r)

    def _maybe_log_throughput(self, r_next: int) -> None:
        if not self._log_every or r_next - self._last_tlog < self._log_every:
            return
        self._last_tlog = r_next
        print(f"[telemetry] round {r_next}: {self.meter.rounds_per_sec():.2f} rounds/s "
              f"({self.meter.total_rounds} rounds in {self.meter.total_seconds:.2f}s)",
              file=sys.stderr)

    def _end_block(self, r: int, k: int, metrics, tau_up, tau_dd, eval_every: int,
                   verbose: bool) -> None:
        """The host's work after rounds ``[r, r + k)`` ran (one round or one
        chunk): stop the clock on the metrics, close the profile window,
        log, re-optimize alpha, evaluate, and checkpoint."""
        dt = self.meter.stop(k, fence=metrics)
        if self.profile is not None:
            self.profile.maybe_stop(r + k)
        self.metrics.log_timing(r, k, dt)
        self._log_compile_growth(r + k - 1)
        self.metrics.log_rounds(r, metrics, k)
        if self.adaptive is not None:
            for i in range(k):
                swapped = self._ingest_adaptive(r + i, tau_up[i], tau_dd[i], verbose)
                if swapped and i != k - 1:  # guarded by _effective_chunk
                    raise RuntimeError(
                        f"adaptive re-opt fired mid-chunk (round {r + i}, chunk "
                        f"[{r}, {r + k})); the cadence must be a multiple of chunk")
        self._maybe_eval(r + k - 1, eval_every, verbose)
        self._maybe_log_throughput(r + k)
        self.round = r + k
        self._maybe_ckpt()

    def _start_block(self, r: int) -> None:
        if self.profile is not None:
            self.profile.maybe_start(r)
        self.meter.start()

    def _maybe_eval(self, r: int, eval_every: int, verbose: bool) -> None:
        if eval_every and (r + 1) % eval_every == 0 and self.eval_fn is not None:
            em = self.eval_fn(self.params)
            self.metrics.log_eval(r, em)
            if verbose:
                print(f"  round {r+1:4d}  loss={self.log.loss[-1]:.4f}  " +
                      "  ".join(f"{k}={v:.4f}" for k, v in em.items()))
        elif verbose and (r + 1) % 10 == 0:
            print(f"  round {r+1:4d}  loss={self.log.loss[-1]:.4f}")

    def _streak_arg(self) -> tuple:
        return (self._streak,) if self.telemetry else ()

    def _run_one(self, r: int, eval_every: int, verbose: bool) -> None:
        """One communication round."""
        self._start_block(r)
        tau_up, tau_dd = self.channel.tau_for_round(r)
        batches = {k: v[0] for k, v in self._stack_batches(1).items()}
        *carry, metrics = self._round_fn(
            self.params, self.server_state, self._own(self.agg_state), batches,
            self._to_device(tau_up, torch.float32), self._to_device(tau_dd, torch.float32),
            self.A, *self._streak_arg())
        self.params, self.server_state, self.agg_state, *streak = carry
        if self.telemetry:
            self._streak = streak[0]
        self._data_rng_snapshot = None  # the live streams sit at the boundary
        self._end_block(r, 1, metrics, tau_up[None], tau_dd[None], eval_every, verbose)

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
        self.metrics.log_reopt(r, S_est=float(info["S_est"]),
                               S_true=float(variance_S(true_m, A_new)),
                               p_err=self.adaptive.estimator.errors(true_m)["p"])
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

    def _take_carry(self, carry) -> None:
        """Keep a chunk's returned carry: params, server and strategy state,
        then the streak when instrumented."""
        self.params, self.server_state, self.agg_state, *streak = self._own(tuple(carry))
        if self.telemetry:
            self._streak = streak[0]

    def _run_chunks(self, r0: int, n_chunks: int, k: int, eval_every: int,
                    verbose: bool) -> None:
        """``n_chunks`` chunks of ``k`` rounds through the chunked engine."""
        if self._scan_fn is None:
            self._scan_fn = self._make_scan_fn(*self._opts, self.rc, telemetry=self.telemetry)
            self.compiles.register("scan_fn", self._scan_fn)
        batches = self._stack_batches(k)
        for c in range(n_chunks):
            r = r0 + c * k
            self._start_block(r)
            tau_up, tau_dd = self.channel.trace(r, k)
            *carry, metrics = self._scan_fn(
                self.params, self.server_state, self.agg_state, batches,
                self._to_device(tau_up, torch.float32), self._to_device(tau_dd, torch.float32),
                self.A, *self._streak_arg())
            self._take_carry(carry)
            # the chunk runs on the device while the host stacks the next
            # chunk's batches (the same client streams, in the same order); a
            # periodic save at this boundary needs the streams from before
            # that (the final save follows the last chunk, which prefetches
            # nothing)
            prefetch = c + 1 < n_chunks
            self._data_rng_snapshot = (
                [rng_state_to_json(cl._rng) for cl in self.clients]
                if prefetch and self._saves_at(r + k) else None)
            batches = self._stack_batches(k) if prefetch else None
            self._end_block(r, k, metrics, tau_up, tau_dd, eval_every, verbose)

    def _run_chunks_sampled(self, r0: int, k: int, eval_every: int, verbose: bool) -> None:
        """One chunk of ``k`` rounds whose taus are drawn inside the round by
        the channel's in-scan sampler, from a generator seeded from the
        trainer's ``seed`` on the device: no tau tensor crosses from the
        host."""
        if self._sampled_scan_fn is None:
            init_fn, sample_fn = self.channel.scan_sampler(self.device)
            self._sampled_scan_fn = self._make_scan_fn(*self._opts, self.rc,
                                                       channel_sampler=sample_fn,
                                                       telemetry=self.telemetry)
            self.compiles.register("sampled_scan_fn", self._sampled_scan_fn)
            # a restored run arrives with the sampler's carry already set
            if self._channel_gen is None:
                self._channel_gen = torch.Generator(device=self.device).manual_seed(self._seed)
                self._channel_state = init_fn(self._channel_gen)
        self._start_block(r0)
        p, ss, ag, self._channel_state, self._channel_gen, *rest = self._sampled_scan_fn(
            self.params, self.server_state, self.agg_state, self._stack_batches(k),
            self._channel_state, self._channel_gen, self.A, *self._streak_arg())
        *streak, metrics = rest
        self._take_carry((p, ss, ag, *streak))
        self._channel_state = self._own(self._channel_state)
        self._data_rng_snapshot = None  # no prefetch on this path
        self._end_block(r0, k, metrics, None, None, eval_every, verbose)

    def run(self, rounds: int, *, chunk: int = 1, eval_every: int = 0,
            verbose: bool = False, no_trace: bool = False, log_every: int = 0,
            ckpt_dir=None, ckpt_every: int = 0, ckpt_keep: int = 3,
            resume_from=None) -> TrainLog:
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

        ``log_every=N`` prints the cumulative rounds/s to stderr every N
        rounds (``self.meter`` measures it either way).

        **Checkpoint/resume.** ``ckpt_dir`` saves the complete run state
        every ``ckpt_every`` rounds (0: only at the end) through a
        background writer, keeping the last ``ckpt_keep``.  Chunked,
        ``ckpt_every`` must be a multiple of the chunk, since the host sees
        only chunk boundaries.  ``resume_from`` (a checkpoint file, or a
        directory whose latest committed step is taken) restores first and
        makes ``rounds`` the total target: ``run(100, resume_from=c40)``
        trains rounds 40..99 and continues the uninterrupted run bitwise.
        """
        if resume_from is not None:
            self.restore(resume_from)
        start = self.round
        end = rounds if resume_from is not None else start + rounds
        if end < start:
            raise ValueError(f"resume target {end} is behind the restored round {start}")
        k = self._effective_chunk(int(chunk), eval_every)
        if no_trace:
            if not hasattr(self.channel, "scan_sampler"):
                raise ValueError(f"no_trace needs a channel with scan_sampler(); "
                                 f"{type(self.channel).__name__} cannot sample in-scan")
            if self.adaptive is not None:
                raise ValueError(
                    "no_trace is incompatible with adaptive re-optimization: the estimator "
                    "consumes realized taus on the host, which no_trace never materializes")
        self._ckpt_every = int(ckpt_every)
        if ckpt_dir is not None:
            if self._ckpt_every > 0 and k > 1 and self._ckpt_every % k != 0:
                raise ValueError(
                    f"ckpt_every={ckpt_every} must be a multiple of the chunk size {k}: "
                    "the chunked engine only reaches the host at chunk boundaries")
            self._ckpt = AsyncCheckpointer(ckpt_dir, keep=ckpt_keep)
            self._ckpt_last = -1
        self._log_every = int(log_every)
        self._last_tlog = start
        try:
            r = start
            while r < end:
                if no_trace:
                    n = min(k, end - r)
                    self._run_chunks_sampled(r, n, eval_every, verbose)
                elif k > 1 and r % k == 0 and r + k <= end:
                    n = (end - r) // k * k
                    self._run_chunks(r, n // k, k, eval_every, verbose)
                else:
                    n = 1
                    self._run_one(r, eval_every, verbose)
                r += n
        except BaseException:
            if self._ckpt is not None:  # drain what was saved; no final save
                self._ckpt.close()
                self._ckpt = None
            raise
        return self._finish_run()

    def _finish_run(self) -> TrainLog:
        """End of run: the final checkpoint and the writer's drain, a profile
        window left open, the sinks flushed (the logger stays open: ``run``
        may be called again; owners call ``self.metrics.close()``)."""
        self._finish_ckpt()
        if self.profile is not None:
            self.profile.close()
        self.metrics.flush()
        return self.log

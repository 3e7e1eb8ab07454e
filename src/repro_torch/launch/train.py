"""The FL training launcher: ColRel federated training of a model of the zoo.

The port of ``repro.launch.train``, on one device (CUDA unless ``--device``
names another).  Every client starts a round from the PS model, takes
``--local-steps`` SGD steps (lr 0.25) on its own token batches, and the
PS applies the strategy's aggregate of the relayed deltas with momentum
(``sgd_momentum(1.0, beta=0.9)``), over a fully connected D2D topology
with COPT-alpha relay weights.  The draws are the reference launcher's:
the batches from ``np.random.default_rng(--seed)``, the channel from
``make_channel(..., seed=--seed)``, the weights from ``optimize_weights``;
the model's init from a ``torch.Generator`` seeded 0.

``--chunk K`` runs the chunked engine: one round captured as a CUDA graph
and replayed K times a chunk (a plain loop on the CPU), the chunk's taus
from one bulk trace and its metrics back in one copy; bitwise the
per-round loop.  ``--no-trace`` draws the taus inside the captured round
from the channel's in-scan sampler, whose generator state rides the
checkpoint.  ``--metrics-dir DIR`` turns on the instrumented round and
writes ``events.jsonl``, ``rounds.csv``, ``manifest.json`` and
``vectors.npz`` there; ``--profile-dir`` records a ``torch.profiler``
trace over ``--profile-rounds`` rounds; ``--log-every N`` prints rounds/s
to stderr.  ``--ckpt-dir`` checkpoints the run (``ckpt_<round:08d>.pt``,
sha256-committed by a background writer) every ``--ckpt-every`` rounds
and at the end; SIGTERM or SIGINT is latched and the run commits a final
checkpoint at the next round or chunk boundary; ``--resume`` continues
from the latest committed one, bitwise.

    python -m repro_torch.launch.train --arch qwen3-0.6b --rounds 10
    python -m repro_torch.launch.train --smoke --device cpu --rounds 8 --chunk 4 \\
        --channel markov --metrics-dir /tmp/colrel_metrics

:func:`train` is the same run from Python; it returns the per-round
metrics as host numbers and the final state.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.ckpt import (
    CKPT_VERSION,
    AsyncCheckpointer,
    CheckpointWriter,
    PreemptionGuard,
    decode_generator,
    encode_generator,
    rng_from_json,
    rng_state_to_json,
)
from repro_torch.configs.base import get_arch
from repro_torch.configs.channels import CHANNEL_PRESETS, make_channel
from repro_torch.core import optimize_weights, topology
from repro_torch.core.flatten import flat_spec
from repro_torch.fl.round import (
    RoundConfig,
    make_async_round_fn,
    make_async_scan_round_fn,
    make_round_fn,
    make_scan_round_fn,
)
from repro_torch.fl.trainer import resolve_device
from repro_torch.models import build, count_params
from repro_torch.optim import sgd, sgd_momentum
from repro_torch.telemetry import (
    CsvSummarySink,
    JsonlSink,
    MetricsLogger,
    ProfileWindow,
    RunManifest,
    ThroughputMeter,
    init_streak,
)

__all__ = ["TrainResult", "build_parser", "train", "main"]

CLIENT_LR = 0.25  # the launcher's client SGD step
SERVER_LR, SERVER_BETA = 1.0, 0.9  # the PS momentum


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke() config")
    ap.add_argument("--aggregation", default="colrel",
                    choices=sorted(strategy_registry.available()),
                    help="aggregation strategy (repro_torch.strategies registry)")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="flatten-once fused aggregation kernel (colrel only)")
    ap.add_argument("--async-mode", action="store_true",
                    help="asynchronous opportunistic relaying: blocked clients' last "
                         "updates age in a staging buffer and the PS applies gamma^age "
                         "staleness weights; wraps --aggregation")
    ap.add_argument("--staleness-gamma", type=float, default=0.9,
                    help="staleness decay base gamma for --async-mode")
    ap.add_argument("--channel", default="static", choices=sorted(CHANNEL_PRESETS),
                    help="connectivity dynamics preset (repro_torch/configs/channels.py)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="rounds a chunk of the captured-round engine (1 = per-round loop)")
    ap.add_argument("--no-trace", action="store_true",
                    help="draw connectivity inside the captured round (channel.scan_sampler; "
                         "no tau tensors from the host)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--p-up", type=float, default=0.3)
    ap.add_argument("--p-c", type=float, default=0.8)
    ap.add_argument("--metrics-dir", default=None,
                    help="telemetry output dir (events.jsonl, rounds.csv, manifest.json, "
                         "vectors.npz); also enables the instrumented round")
    ap.add_argument("--log-every", type=int, default=0,
                    help="print cumulative rounds/sec every N rounds")
    ap.add_argument("--profile-dir", default=None,
                    help="record a torch.profiler trace into this dir")
    ap.add_argument("--profile-rounds", type=int, default=4,
                    help="profiler window length in rounds (with --profile-dir)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (sha256-committed ckpt_NNNNNNNN.pt snapshots, "
                         "written in the background)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in rounds (0 = final only; must be a multiple "
                         "of --chunk)")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="committed checkpoints retained (keep-last-k)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest committed checkpoint in --ckpt-dir and continue "
                         "to --rounds")
    ap.add_argument("--segment-d", type=int, default=0,
                    help="d threshold for segment-streaming aggregation (0 = monolithic stack)")
    ap.add_argument("--no-donate", action="store_true",
                    help="keep clones of the carry each round or chunk returns instead of "
                         "letting the next one overwrite it (for A/B memory measurement)")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    return ap


def _validate(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The reference launcher's refusals, with its messages (exit code 2)."""
    # the fused kernel only exists on the colrel path; refuse the silently
    # inert combination rather than measuring the wrong code
    if args.fused_kernel and args.aggregation != "colrel":
        ap.error(f"--fused-kernel requires --aggregation colrel (got {args.aggregation})")
    if args.chunk < 1 or args.rounds % args.chunk != 0:
        ap.error(f"--chunk must be positive and divide --rounds "
                 f"(got chunk={args.chunk}, rounds={args.rounds})")
    if args.no_trace and args.chunk == 1:
        ap.error("--no-trace runs through the chunked engine; pass --chunk K > 1")
    if (args.resume or args.ckpt_every) and not args.ckpt_dir:
        ap.error("--resume and --ckpt-every require --ckpt-dir")
    if args.ckpt_every and args.ckpt_every % args.chunk != 0:
        # the chunked engine only reaches the host at chunk boundaries, so a
        # misaligned cadence cannot be honored: refuse, don't approximate
        ap.error(f"--ckpt-every must be a multiple of --chunk (got "
                 f"ckpt_every={args.ckpt_every}, chunk={args.chunk}): "
                 f"checkpoints commit at chunk boundaries only")


@dataclasses.dataclass
class TrainResult:
    """What a run leaves: every scalar metric of the round, one float a
    round under the round's keys (a resumed run's include the rounds before
    its checkpoint), the round reached, and the final carry."""

    metrics: Dict[str, List[float]]
    rounds: int
    params: Any
    server_state: Any
    agg_state: Any
    #: the chunked engine's capture statistics (``ScanRound.stats``); empty per round
    scan_stats: Dict[str, Any]
    #: one ``{rounds, seconds, rounds_per_sec}`` a round or chunk run, fenced
    #: on its metrics (``ThroughputMeter.chunks``)
    blocks: List[Dict[str, float]]


def train(argv_or_args: Union[Sequence[str], argparse.Namespace, None] = None, *,
          params: Any = None) -> TrainResult:
    """One launch, as ``python -m repro_torch.launch.train`` runs it.
    ``params`` starts from the given model parameters (moved to the device)
    instead of the init drawn from seed 0."""
    ap = build_parser()
    args = (argv_or_args if isinstance(argv_or_args, argparse.Namespace)
            else ap.parse_args(argv_or_args))
    _validate(ap, args)
    dev = resolve_device(args.device)
    strategy = strategy_registry.get(
        args.aggregation,
        **({"fused": "kernel"} if args.fused_kernel
           else {"fused": "collapse"} if args.aggregation == "colrel" else {}))
    if args.async_mode:
        if getattr(strategy, "is_async", False):
            ap.error(f"--aggregation {args.aggregation} is already asynchronous; "
                     f"drop --async-mode")
        strategy = strategy_registry.AsyncRelayStrategy(inner=strategy,
                                                        gamma=args.staleness_gamma)
    # async strategies (--async-mode or --aggregation async_colrel) run
    # through the age-carrying round builders
    is_async = getattr(strategy, "is_async", False)
    mk_round = make_async_round_fn if is_async else make_round_fn
    mk_scan = make_async_scan_round_fn if is_async else make_scan_round_fn

    arch = get_arch(args.arch)
    cfg = arch.smoke() if args.smoke else arch.full()
    bundle = build(cfg)
    if params is None:
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    else:
        params = tree.map(lambda x: torch.as_tensor(x).to(dev), params)
    print(f"{cfg.name}: {count_params(params):,} params on {dev}")

    n = args.n_clients
    link_model = topology.fully_connected(n, args.p_up, p_c=args.p_c, rho=1.0)
    channel = make_channel(args.channel, link_model, n=n, seed=args.seed)
    if args.no_trace and not hasattr(channel, "scan_sampler"):
        ap.error(f"--no-trace needs a channel with scan_sampler() "
                 f"(--channel {args.channel} cannot sample in-scan)")
    res = optimize_weights(link_model, sweeps=20, fine_tune_sweeps=20)
    print(f"COPT-alpha: S {res.S_init:.2f} -> {res.S:.2f}")
    A = torch.as_tensor(np.asarray(res.A), dtype=torch.float32).to(dev)

    rc = RoundConfig(n_clients=n, local_steps=args.local_steps, mode="per_client",
                     aggregation=strategy, segment_d=args.segment_d)
    # with donation the next round or chunk may write the carry in place
    # (the chunked engine returns its static buffers); without, the run
    # keeps clones
    donate = not args.no_donate

    def own(carry):
        if donate:
            return carry
        return tree.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, carry)

    server_opt = sgd_momentum(SERVER_LR, beta=SERVER_BETA)
    client_opt = sgd(CLIENT_LR)
    sstate = server_opt.init(params)
    agg_state = strategy.init_state(n, flat_spec(params).d, device=dev)

    def on_device(x):
        return tree.map(lambda t: torch.as_tensor(t).to(dev), x)

    # the restore source, found up front so the telemetry sinks open in the
    # right mode and the manifest records where the run came from
    resume_state = resume_path = None
    if args.resume:
        reader = CheckpointWriter(args.ckpt_dir, keep=args.ckpt_keep)
        step = reader.latest_step()
        if step is None:
            ap.error(f"--resume: no committed checkpoint in {args.ckpt_dir}")
        resume_path = reader.path_for(step)
        resume_state = reader.load(step)
        print(f"resuming from {resume_path} (round {step})")

    telemetry = args.metrics_dir is not None
    sinks = []
    if telemetry:
        mdir = pathlib.Path(args.metrics_dir)
        sinks = [JsonlSink(mdir / "events.jsonl", resume=args.resume),
                 CsvSummarySink(mdir / "rounds.csv", resume=args.resume)]
        RunManifest.collect(
            vars(args), device=dev, strategy=strategy.name, channel=args.channel,
            codec=getattr(getattr(strategy, "codec", None), "name", None),
            arch=cfg.name, n_clients=n, resumed_from=resume_path).write(mdir)
        print(f"telemetry -> {mdir}")
    # every round's metrics go through the logger (to the sinks only with
    # telemetry on): the host copy the printed lines and the result read
    logger = MetricsLogger(sinks)
    profile = (ProfileWindow(args.profile_dir, rounds=args.profile_rounds)
               if args.profile_dir else None)
    meter = ThroughputMeter()
    streak = init_streak(n, dev) if telemetry else None
    last_tlog = 0

    def tick(r0: int, k: int, metrics) -> None:
        """Per-block bookkeeping: fence and clock, log, throughput line."""
        nonlocal last_tlog
        dt = meter.stop(k, fence=metrics)
        if profile is not None:
            profile.maybe_stop(r0 + k)
        if telemetry:
            logger.log_timing(r0, k, dt)
        logger.log_rounds(r0, metrics, k)
        if args.log_every and r0 + k - last_tlog >= args.log_every:
            last_tlog = r0 + k
            print(f"[telemetry] round {r0 + k}: {meter.rounds_per_sec():.2f} rounds/s",
                  file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    V, S, B, T = cfg.vocab_size, args.seq_len, args.batch, args.local_steps

    # the restored state: model, optimizer and strategy tensors, the channel's
    # generator, the batch stream, the in-scan sampler's carry and the
    # telemetry cursors
    r_start = 0
    ch_state = ch_rng = None  # the in-scan sampler's carry (--no-trace)
    if resume_state is not None:
        if resume_state.get("version") != CKPT_VERSION:
            sys.exit(f"checkpoint version {resume_state.get('version')!r} != "
                     f"supported {CKPT_VERSION}")
        for field, want in (("kind", "launch"), ("strategy", strategy.name),
                            ("arch", cfg.name)):
            got = resume_state.get(field)
            if got != want:
                sys.exit(f"checkpoint {field} mismatch: saved {got!r}, launching {want!r}")
        if (resume_state.get("no_trace") is not None) != args.no_trace:
            sys.exit("checkpoint --no-trace mode does not match this launch; "
                     "resume with the same connectivity flags")
        params = on_device(resume_state["params"])
        sstate = on_device(resume_state["server_state"])
        agg_state = strategy.restore_state(resume_state["agg_state"], device=dev,
                                           like=agg_state)
        rng = rng_from_json(resume_state["rng"])
        channel.restore_state(resume_state["channel"])
        if telemetry:
            if resume_state.get("streak") is None:
                sys.exit("checkpoint carries no telemetry state but --metrics-dir is set; "
                         "resume with matching flags")
            streak = torch.as_tensor(resume_state["streak"], dtype=torch.int32).to(dev)
        logger.restore_state(resume_state["metrics"])
        r_start = int(resume_state["round"])
        if r_start >= args.rounds:
            print(f"checkpoint already at round {r_start} >= --rounds {args.rounds}; "
                  f"nothing to do")
            logger.close()
            return TrainResult(logger.round_metrics, r_start, params, sstate, agg_state, {}, [])
        if r_start % args.chunk != 0:
            sys.exit(f"checkpoint round {r_start} is not a --chunk {args.chunk} boundary")
        last_tlog = r_start

    # snapshots are taken at round boundaries and written by a background
    # thread while the next block runs; SIGTERM/SIGINT is latched and the
    # loop commits a final checkpoint at the next boundary
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=args.ckpt_keep) if args.ckpt_dir else None
    ckpt_last = -1
    stack = contextlib.ExitStack()
    guard = stack.enter_context(PreemptionGuard())

    def capture(r_next: int) -> dict:
        """The launcher's complete run state at round boundary r_next."""
        return {
            "version": CKPT_VERSION, "kind": "launch",
            "round": int(r_next), "strategy": strategy.name, "arch": cfg.name,
            "params": params, "server_state": sstate,
            "agg_state": strategy.checkpoint_state(agg_state),
            "rng": rng_state_to_json(rng),
            "channel": channel.checkpoint_state(),
            "no_trace": ({"state": ch_state, "rng": encode_generator(ch_rng)}
                         if args.no_trace else None),
            "streak": streak,
            "metrics": logger.checkpoint_state(),
        }

    def boundary(r_next: int) -> bool:
        """Periodic checkpoint and preemption check at a round boundary;
        True stops the loop (the final checkpoint commits the state)."""
        nonlocal ckpt_last
        if (ckpt is not None and args.ckpt_every and r_next % args.ckpt_every == 0
                and r_next != ckpt_last):
            ckpt.save(r_next, capture(r_next))
            ckpt_last = r_next
        if guard.triggered:
            print(f"[ckpt] preempted (signal {guard.signum}) at round {r_next}; "
                  f"committing final checkpoint", file=sys.stderr)
            return True
        return False

    def make_batches(lead: tuple) -> Dict[str, torch.Tensor]:
        toks = rng.integers(0, V, size=(*lead, S + 1), dtype=np.int32)
        batches = {"tokens": torch.from_numpy(toks[..., :-1].astype(np.int64)).to(dev),
                   "labels": torch.from_numpy(toks[..., 1:].astype(np.int64)).to(dev)}
        if cfg.frontend_tokens:
            batches["prefix"] = torch.from_numpy(
                rng.normal(size=(*lead, cfg.frontend_tokens, cfg.d_model))).to(
                dev, cfg.tdtype)
        return batches

    def taus(tau_up, tau_dd):
        return (torch.as_tensor(tau_up, dtype=torch.float32).to(dev),
                torch.as_tensor(tau_dd, dtype=torch.float32).to(dev))

    def last(k: int) -> Dict[str, List[float]]:
        return {key: v[-k:] for key, v in logger.round_metrics.items()}

    scan_fn = None
    done = r_start
    try:
        if args.chunk == 1:
            round_fn = mk_round(bundle.loss_fn, client_opt, server_opt, rc, telemetry=telemetry)
            for r in range(r_start, args.rounds):
                if profile is not None:
                    profile.maybe_start(r)
                meter.start()
                tau_up, tau_dd = channel.tau_for_round(r)
                batches = make_batches((n, T, B))
                t0 = time.perf_counter()
                out = round_fn(params, sstate, own(agg_state), batches, *taus(tau_up, tau_dd),
                               A, *((streak,) if telemetry else ()))
                params, sstate, agg_state, *rest, metrics = out
                if telemetry:
                    streak = rest[0]
                tick(r, 1, metrics)
                m = last(1)
                stale = f"stale={m['stale_frac'][0]:.2f}  " if "stale_frac" in m else ""
                print(f"round {r:3d}  loss={m['loss'][0]:.4f}  "
                      f"participants={int(m['participation'][0])}/{n}  "
                      f"|delta|={m['delta_norm'][0]:.3f}  {stale}"
                      f"({time.perf_counter() - t0:.2f}s)")
                done = r + 1
                if boundary(done):
                    break
        else:
            # the chunked engine: K replays of one captured round a chunk, one
            # host round trip; the taus from the channel's bulk trace, or with
            # --no-trace drawn inside the round (the sampler's state and
            # generator carried across chunks)
            K = args.chunk
            if args.no_trace:
                init_fn, sample_fn = channel.scan_sampler(dev)
                scan_fn = mk_scan(bundle.loss_fn, client_opt, server_opt, rc,
                                  channel_sampler=sample_fn, telemetry=telemetry)
                ch_rng = torch.Generator(device=dev).manual_seed(args.seed)
                if resume_state is not None:
                    nt = resume_state["no_trace"]
                    ch_state = on_device(nt["state"])
                    decode_generator(nt["rng"], into=ch_rng)
                else:
                    ch_state = init_fn(ch_rng)
            else:
                scan_fn = mk_scan(bundle.loss_fn, client_opt, server_opt, rc,
                                  telemetry=telemetry)
            for c in range(r_start // K, args.rounds // K):
                r0 = c * K
                if profile is not None:
                    profile.maybe_start(r0)
                meter.start()
                batches = make_batches((K, n, T, B))
                t0 = time.perf_counter()
                streak_arg = (streak,) if telemetry else ()
                if args.no_trace:
                    params, sstate, agg_state, ch_state, _, *rest = scan_fn(
                        params, sstate, agg_state, batches, ch_state, ch_rng, A, *streak_arg)
                    ch_state = own(ch_state)
                else:
                    params, sstate, agg_state, *rest = scan_fn(
                        params, sstate, agg_state, batches, *taus(*channel.trace(r0, K)), A,
                        *streak_arg)
                *streak_out, metrics = rest
                params, sstate, agg_state = own((params, sstate, agg_state))
                if telemetry:
                    streak = own(streak_out[0])
                tick(r0, K, metrics)
                dt = time.perf_counter() - t0
                m = last(K)
                part = np.mean(m["participation"])
                print(f"rounds {r0:3d}-{r0 + K - 1:3d}  "
                      f"loss={m['loss'][0]:.4f}->{m['loss'][-1]:.4f}  "
                      f"participants(mean)={part:.1f}/{n}  "
                      f"uplink={sum(m['uplink_bits']) / 8e6:.1f} MB  "
                      f"({dt:.2f}s, {K / dt:.1f} rounds/s)")
                done = r0 + K
                if boundary(done):
                    break
        # drain the writer; commit a final checkpoint unless the last
        # boundary was saved
        if ckpt is not None:
            if done != ckpt_last:
                ckpt.save(done, capture(done))
            ckpt.close()
            ckpt = None
            print(f"[ckpt] committed round {done} -> {args.ckpt_dir}")
    finally:
        stack.close()  # the original signal handlers back
        if ckpt is not None:  # failed mid-run: drain what was saved
            ckpt.close()
        if profile is not None:
            profile.close()
    if telemetry:
        logger.save_vectors(pathlib.Path(args.metrics_dir) / "vectors.npz")
        print(f"telemetry: {meter.total_rounds} rounds in {meter.total_seconds:.2f}s "
              f"({meter.rounds_per_sec():.2f} rounds/s)")
    logger.close()
    stats = dict(scan_fn.stats) if scan_fn is not None else {}
    return TrainResult(logger.round_metrics, done, params, sstate, agg_state, stats,
                       meter.chunks)


def main(argv: Optional[Sequence[str]] = None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

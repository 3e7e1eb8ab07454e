"""The paper's CIFAR-10 experiment (Sec. V) on the PyTorch port.

ResNet-20-family CNN, n=10 clients, T=8 local steps, SGD lr=0.05 +
weight decay 1e-4, PS momentum 0.9 — every protocol constant at the
paper's value.  Data is synthetic-CIFAR.  Saves a JSON training log and a
checkpoint of the final params (``torch.save`` format, ``<out>.pt``).

    PYTHONPATH=src python examples/train_colrel_cifar_torch.py \
        --topology fig2b --strategy colrel --non-iid-s 3 --rounds 200

Runs on the CUDA device unless ``--device`` names another.  The whole
experiment is one declarative :class:`ExperimentSpec`
(``repro_torch/fl/experiment.py``); this script is argv -> spec -> run.
``--strategy`` enumerates the strategy registry
(``repro_torch.strategies``), so a registered scheme such as ``multihop``
(K-hop relaying) or ``memory`` (implicit gossip) appears here; pass
constructor options as ``--strategy-opt hops=3``.

``--channel`` swaps the i.i.d. connectivity for a dynamic channel preset
(``markov`` = bursty Gilbert–Elliott blockage with the same marginals,
``mobility`` = waypoint-drifting mmWave geometry; see
``repro_torch/configs/channels.py``), and ``--adaptive`` drops the oracle
link knowledge: alpha is re-optimized every ``--reopt-every`` rounds from
online link estimates.

    PYTHONPATH=src python examples/train_colrel_cifar_torch.py \
        --channel markov --strategy memory --rounds 200
"""

import argparse
import json

from repro_torch import strategies
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import CHANNEL_PRESETS
from repro_torch.fl import TOPOLOGIES, ExperimentSpec, build_experiment


def parse_opt(kv: str):
    """``key=value`` -> ``(key, typed value)``.

    Values are decoded, not passed through as bare strings: ints,
    floats, ``true``/``false`` and ``none`` all arrive as their Python
    types (strategy constructors like ``multihop(hops=3)`` take typed
    arguments).  Dotted keys address nested option dicts — see
    :func:`build_options`.
    """
    key, sep, raw = kv.partition("=")
    if not sep:
        raise argparse.ArgumentTypeError(f"expected key=value, got {kv!r}")
    for cast in (int, float):
        try:
            return key, cast(raw)
        except ValueError:
            pass
    low = raw.lower()
    if low in ("true", "false"):
        return key, low == "true"
    if low == "none":
        return key, None
    return key, raw


def build_options(pairs):
    """``[(key, value), ...]`` -> kwargs dict, expanding dotted keys
    into nested dicts: ``codec_options.bits=4`` becomes
    ``{"codec_options": {"bits": 4}}`` (how the ``quantized`` strategy's
    codec options are spelled on the command line)."""
    out = {}
    for key, value in pairs:
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise SystemExit(f"--strategy-opt {key}: {p!r} is already "
                                 "a scalar option")
        leaf = parts[-1]
        if isinstance(node.get(leaf), dict) and not isinstance(value, dict):
            raise SystemExit(f"--strategy-opt {key}: {leaf!r} already holds "
                             "nested options")
        node[leaf] = value
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default="fig2b", choices=sorted(TOPOLOGIES))
    ap.add_argument("--strategy", default="colrel",
                    choices=sorted(strategies.available()))
    ap.add_argument("--strategy-opt", action="append", default=[],
                    type=parse_opt, metavar="KEY=VALUE",
                    help="strategy constructor option (repeatable, typed, "
                         "dotted keys nest), e.g. --strategy-opt hops=3 or "
                         "--strategy-opt codec_options.bits=4")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--non-iid-s", type=int, default=0, help="0 = IID")
    ap.add_argument("--channel", default="static", choices=sorted(CHANNEL_PRESETS),
                    help="link dynamics preset (repro_torch/configs/channels.py)")
    ap.add_argument("--adaptive", action="store_true",
                    help="estimate links online + re-optimize alpha "
                         "(no oracle link knowledge)")
    ap.add_argument("--reopt-every", type=int, default=50,
                    help="adaptive alpha re-optimization cadence (rounds)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="rounds per chunk of the chunked engine (one round "
                         "captured as a CUDA graph and replayed); must divide "
                         "the eval/re-opt cadences or the trainer falls back "
                         "to the per-round loop")
    ap.add_argument("--full-width", action="store_true",
                    help="paper-width ResNet-20 (slow on CPU)")
    ap.add_argument("--out", default="colrel_cifar")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--metrics-dir", default=None,
                    help="telemetry dir (events.jsonl, rounds.csv, "
                         "manifest.json, vectors.npz); implies the "
                         "instrumented round")
    ap.add_argument("--log-every", type=int, default=0,
                    help="print cumulative rounds/sec every N rounds")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace into this dir")
    ap.add_argument("--profile-rounds", type=int, default=4,
                    help="profiler window length in rounds")
    args = ap.parse_args()

    strategy_options = build_options(args.strategy_opt)
    if args.adaptive:
        # derive the guard from the registry, not a hardcoded name list:
        # adaptive re-optimizes alpha, which only A-reading strategies use
        probe = strategies.get(args.strategy, **strategy_options)
        if not probe.needs_A:
            raise SystemExit(
                f"--adaptive re-optimizes the relay alpha, which "
                f"{args.strategy!r} ignores (needs_A=False); A-reading "
                f"strategies: "
                f"{[n for n in strategies.available() if strategies.get(n).needs_A]}"
            )

    spec = ExperimentSpec(
        model="cifar_cnn_full" if args.full_width else "cifar_cnn",
        topology=args.topology,
        non_iid_s=args.non_iid_s,
        strategy=args.strategy,
        strategy_options=strategy_options,
        channel=args.channel,
        adaptive=args.adaptive,
        reopt_every=args.reopt_every,
        rounds=args.rounds,
        chunk=args.chunk,
        metrics_dir=args.metrics_dir,
        log_every=args.log_every,
        profile_dir=args.profile_dir,
        profile_rounds=args.profile_rounds,
    )
    exp = build_experiment(spec, device=args.device)
    if exp.copt_result is not None:
        res = exp.copt_result
        print(f"COPT-alpha: S {res.S_init:.2f} -> {res.S:.2f}")
    elif args.adaptive:
        print(f"adaptive alpha: identity start, re-opt every {args.reopt_every}")
    exp.run(eval_every=max(args.rounds // 10, 1), verbose=True)
    exp.close()  # per-client summary event + vectors.npz + sink flush

    log = exp.log.to_dict()
    log["config"] = {**vars(args), "strategy_opt": strategy_options}
    with open(f"{args.out}.json", "w") as f:
        json.dump(log, f, indent=1)
    save_checkpoint(f"{args.out}.pt", exp.params)
    final = exp.log.eval_metrics[-1] if exp.log.eval_metrics else {}
    print(f"\nfinal: {final}  (log -> {args.out}.json, ckpt -> {args.out}.pt)")


if __name__ == "__main__":
    main()

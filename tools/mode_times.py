#!/usr/bin/env python3
"""Seconds a round of the round modes and async relaying on the card, in
turns, with the kernels the device runs a round.

    python3 tools/mode_times.py [--rounds 2] [--turns 2]

Paths, all ``cifar_cnn_full`` at the paper's T = 8 from the same spec
seed: ``per_client`` colrel kernel (static channel), ``client_sequential``
(static), async colrel kernel (Markov channel, gamma 0.8, no relay
rescue), and per_client colrel kernel on the Markov channel (the async
path's channel without the async carry).  Each turn times ``--rounds``
rounds per round of every path, then one chunk of K = 4 of every path
(captured before the first turn); the turns alternate the order of the
paths (A B C D, then D C B A).  Then one per-round round and one replayed
chunk of each path under ``torch.profiler``: device kernels and their
busy time a round, and the host's wall.  Needs one CUDA card; prints the
card's name and power limit beside every number.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

K = 4
ASYNC = dict(mode="async", async_options={"gamma": 0.8, "opportunistic": False},
             channel="markov")
PATHS = {
    "per_client colrel kernel": dict(strategy_options={"fused": "kernel"}),
    "client_sequential": dict(mode="client_sequential"),
    "async colrel kernel": dict(ASYNC, strategy_options={"fused": "kernel"}),
    "per_client colrel kernel, markov": dict(strategy_options={"fused": "kernel"},
                                             channel="markov"),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mode_times: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    card = card_line()
    print(f"[mode_times] {card}; torch {torch.__version__}")
    per = {k: build_experiment(ExperimentSpec(model="cifar_cnn_full", **kw))
           for k, kw in PATHS.items()}
    chunked = {k: build_experiment(ExperimentSpec(model="cifar_cnn_full", **kw))
               for k, kw in PATHS.items()}
    for label in PATHS:  # one unmeasured round, and the capture
        per[label].run(1)
        chunked[label].run(K, chunk=K)
    torch.cuda.synchronize()
    per_s = {k: [] for k in PATHS}
    chunk_s = {k: [] for k in PATHS}
    order = list(PATHS)
    for turn in range(args.turns):
        for label in (order if turn % 2 == 0 else order[::-1]):
            for _ in range(args.rounds):
                t = time.perf_counter()
                per[label].run(1)
                torch.cuda.synchronize()
                per_s[label].append(time.perf_counter() - t)
        for label in (order if turn % 2 == 0 else order[::-1]):
            t = time.perf_counter()
            chunked[label].run(K, chunk=K)
            torch.cuda.synchronize()
            chunk_s[label].append((time.perf_counter() - t) / K)
    for label in PATHS:
        print(f"[mode_times] {label}: per round {[round(x, 4) for x in per_s[label]]} (median "
              f"{statistics.median(per_s[label]):.4f} s), chunked K={K} "
              f"{[round(x, 4) for x in chunk_s[label]]} (mean "
              f"{statistics.mean(chunk_s[label]):.4f} s) [{card}]")
    for label in PATHS:
        for what, exp, k in (("per round", per[label], 1), ("chunked", chunked[label], K)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                exp.run(k, chunk=k)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) / k
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6 / k
            count = sum(e.count for e in kernels) / k
            print(f"[mode_times] {label}, {what} under the profiler: {count:.0f} device kernels "
                  f"a round, device busy {busy:.4f} s of a {wall:.4f} s round "
                  f"({100 * busy / wall:.1f}%) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

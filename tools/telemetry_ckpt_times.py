#!/usr/bin/env python3
"""Telemetry's and a checkpoint's cost on the colrel kernel path, in turns,
and where a save's blocked time goes.

    python3 tools/telemetry_ckpt_times.py [--turns 8]

Three experiments of ``cifar_cnn_full`` (colrel, ``fused="kernel"``, the
static channel, the paper's T = 8) from one spec seed, each captured by one unmeasured chunk
of K = 4: A telemetry off, B telemetry on, C telemetry off with a
checkpoint every chunk (``ckpt_every=4``: the first save of a reading
overlaps its second chunk, the final one is waited for at the run's end).
A reading is one ``run`` of two chunks; turn t reads A B C when t is even,
C B A when it is odd.  Printed: each variant's s/round, its spread, and
the per-turn ratios B/A and C/A with their mean and standard error, the
resolution the readings give.

Every save of C is split into the capture of the run state and the
snapshot (the pinned copies), with the garbage collector's pauses and the
host allocator's new pinned blocks inside it.  Then one more chunk of C
runs under ``torch.profiler``: the host events inside each save, by self
time.  Needs one CUDA card; prints the card's name and power limit beside
every number.
"""

from __future__ import annotations

import argparse
import gc
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

K = 4


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def host_allocs() -> tuple:
    """Pinned blocks the host allocator has allocated through CUDA so far,
    and its time in those calls as it counts it (None where this torch
    does not count them)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    st = stats() if stats is not None else {}
    return st.get("num_host_alloc"), st.get("host_alloc_time.total")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("telemetry_ckpt_times: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    card = card_line()
    print(f"[times] {card}; torch {torch.__version__}")
    ck = ROOT / "build" / "telemetry_ckpt_times"
    shutil.rmtree(ck, ignore_errors=True)
    variants = {"A off": dict(), "B on": dict(telemetry=True),
                "C off, save every chunk": dict(ckpt_dir=str(ck), ckpt_every=K, ckpt_keep=2)}
    exps = {v: build_experiment(ExperimentSpec(
        model="cifar_cnn_full", strategy_options={"fused": "kernel"},
        **kw)) for v, kw in variants.items()}

    # every save of C: the capture, the snapshot, the collector's pauses and
    # the new pinned blocks inside it
    pauses = []
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            pauses.append((gc_t0[0], time.perf_counter(), info["generation"]))

    gc.callbacks.append(on_gc)
    c_trainer = exps["C off, save every chunk"].trainer
    plain_save = c_trainer._save_async
    saves = []
    in_profile = [False]

    def timed_save():
        a0, t0 = host_allocs(), time.perf_counter()
        with record_function("ckpt.save"):
            plain_save()
        t1 = time.perf_counter()
        rec = c_trainer.ckpt_records[-1]  # the writer adds its commit to it
        rec["gc_ms"] = sum((b - a) * 1e3 for a, b, _ in pauses if a >= t0 and b <= t1)
        rec["gc_gens"] = [g for a, b, g in pauses if a >= t0 and b <= t1]
        a1 = host_allocs()
        rec["new_pinned"] = [None if x is None else y - x for x, y in zip(a0, a1)]
        rec["profiled"] = in_profile[0]
        saves.append(rec)

    c_trainer._save_async = timed_save

    for v in variants:  # the warm-up and the capture
        exps[v].run(K, chunk=K)
    torch.cuda.synchronize()
    secs = {v: [] for v in variants}
    order = list(variants)
    for t in range(args.turns):
        for v in (order if t % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            exps[v].run(2 * K, chunk=K)
            torch.cuda.synchronize()
            secs[v].append((time.perf_counter() - t0) / (2 * K))
    for v in variants:
        st = exps[v].trainer._scan_fn.stats
        if st["captures"] != 1:
            print(f"[times] {v}: {st['captures']} captures", file=sys.stderr)
            return 1
        s = secs[v]
        print(f"[times] s/round colrel kernel T=8 K={K}, {v}: "
              f"{[round(x, 4) for x in s]} mean {statistics.mean(s):.4f} median "
              f"{statistics.median(s):.4f} spread (max-min)/mean "
              f"{100 * (max(s) - min(s)) / statistics.mean(s):.2f}% [{card}]")
    base = secs["A off"]
    for v in order[1:]:
        ratios = [x / a for x, a in zip(secs[v], base)]
        se = statistics.stdev(ratios) / len(ratios) ** 0.5
        print(f"[times] {v} / A off, per turn: {[round(r, 4) for r in ratios]} mean "
              f"{statistics.mean(ratios):.4f} +- {se:.4f} (standard error, "
              f"{len(ratios)} turns) [{card}]")

    # one more chunk of C under the profiler: the host events inside its save
    in_profile[0] = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        exps["C off, save every chunk"].run(K, chunk=K)
        torch.cuda.synchronize()
    gc.callbacks.remove(on_gc)
    events = prof.events()
    for win in [e for e in events if e.name == "ckpt.save"]:
        lo, hi = win.time_range.start, win.time_range.end
        by = {}
        for e in events:
            if (e is not win and e.thread == win.thread and e.time_range.start >= lo
                    and e.time_range.end <= hi):
                by[e.name] = by.get(e.name, 0.0) + e.self_cpu_time_total
        top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
        print(f"[times] a profiled save, {(hi - lo) / 1e3:.2f} ms under the profiler; host "
              "self time by event: " + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in top)
              + f" [{card}]")
    for r in saves:
        cap = r["block_s"] - r["snapshot_s"]
        print(f"[times] save step {r['step']}{' (profiled)' if r['profiled'] else ''}: "
              f"{r.get('bytes')} bytes, blocked {r['block_s'] * 1e3:.2f} ms = capture "
              f"{cap * 1e3:.2f} + snapshot {r['snapshot_s'] * 1e3:.2f}; collector "
              f"{r['gc_ms']:.2f} ms (generations {r['gc_gens']}); new pinned blocks "
              f"and their alloc time {r['new_pinned']}; commit {r.get('commit_s', float('nan')) * 1e3:.2f} ms [{card}]")
    timed = [r for r in saves if not r["profiled"]][1:]  # after the warm-up's
    blocked = sorted(r["block_s"] * 1e3 for r in timed)
    print(f"[times] {len(timed)} timed saves blocked the loop, ms: min {blocked[0]:.2f} median "
          f"{statistics.median(blocked):.2f} max {blocked[-1]:.2f} [{card}]")
    shutil.rmtree(ck, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the model zoo's serving time goes on the card: one prefill and a
few decode steps of each model that ``chip_smoke.py`` phase 11 serves,
timed alone and under ``torch.profiler``.

    python3 tools/zoo_profile.py [--models olmo-1b,granite-moe-3b-a800m] [--steps 8]

Each model at full width and depth in bf16, the port's own init from seed
0 (jamba-1.5-large-398b at one period with 4 of its 16 experts, as in
phase 11): the prefill on 4 x 1024 tokens (jamba 1 x 1024; internvl2 with
1024 synthetic patches in front), with the memory allocated before it and
its peak; then ``--steps`` serve steps on 4 requests (jamba 1), each
synchronised, after one unmeasured step.  For both: the host wall, the
device's busy time and share under the profiler, the number of device
kernels, and the top device operations by self time.  Needs one CUDA card;
prints the card's name and power limit beside every number.
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
from torch.profiler import ProfilerActivity, profile  # noqa: E402

MODELS = ("olmo-1b", "qwen3-0.6b", "gemma3-1b", "internvl2-2b", "granite-moe-3b-a800m",
          "rwkv6-1.6b", "jamba-1.5-large-398b")
B, T = 4, 1024


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profiled(label, fn, card, top=6):
    """Run ``fn`` under the profiler: print its wall, the device's busy
    share and the top device operations."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels [{card}]")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"[profile]   {e.key[:72]:72s} calls={e.count:6d} "
              f"ms={e.self_device_time_total / 1e3:8.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build, count_params

    dev = torch.device("cuda")
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    with torch.inference_mode():
        for arch in args.models.split(","):
            cfg = get_arch(arch).full()
            b = B
            if cfg.arch_type == "hybrid":
                cfg, b = cfg.replace(n_layers=8, n_experts=4), 1
            bundle = build(cfg)
            gen = torch.Generator(device=dev).manual_seed(0)
            params = bundle.init(gen)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, T), generator=gen, device=dev)}
            if cfg.arch_type == "vlm":
                batch["prefix"] = torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                                              generator=gen, device=dev)
            print(f"[zoo] {arch} ({cfg.arch_type}, {cfg.n_layers} layers, "
                  f"{count_params(params):,} params, {cfg.dtype})")
            prefill = build_step(bundle, "prefill")
            prefill(params, batch)  # sets up cuBLAS
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            print(f"[zoo] {arch} prefill {b} x {T}: {1e3 * (time.perf_counter() - t):.1f} ms, "
                  f"{held:.2f} GB allocated before, peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                  f" GB [{card}]")
            profiled(f"{arch} prefill {b} x {T}", lambda: prefill(params, batch), card)
            step = build_step(bundle, "decode")
            cache = bundle.init_cache(b, 2 * args.steps + 2, device=dev)
            tok = batch["tokens"][:, :1]
            step(params, cache, tok, 0)
            secs = []
            for t_ in range(1, args.steps + 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(params, cache, tok, t_)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            print(f"[zoo] {arch} decode ({b} requests): {1e3 * statistics.median(secs):.3f} ms/step "
                  f"(median of {args.steps}) [{card}]")
            profiled(f"{arch} {args.steps} decode steps ({b} requests)",
                     lambda: [step(params, cache, tok, args.steps + 1 + i)
                              for i in range(args.steps)], card)
            del params, cache, batch, bundle, prefill, step
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

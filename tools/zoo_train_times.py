#!/usr/bin/env python3
"""Where the time and the memory of training qwen3-0.6b at full width go,
on one CUDA card.

    PYTHONPATH=src python tools/zoo_train_times.py [--steps 8] [--rounds 3]

qwen3-0.6b ``full()`` (28 layers, d_model 1024, bf16, 596 M params, the
port's init from seed 0), the launcher's defaults (8 clients, 4 local
steps, batch 4 x 64 tokens):

1. one client step (forward and backward of ``loss_fn``, the gradient of
   every leaf) with the stacked layers taken apart by one ``unbind`` a
   leaf (the port's forward) and by indexing each layer (``x[i]``, whose
   backward writes a zero gradient the size of the whole stack for every
   layer), in turns unbind, index, index, unbind: device ms a step by CUDA
   events over ``--steps`` steps, peak GB, and the top device operations
   of one step under ``torch.profiler``;
2. ``--rounds`` rounds of ``python -m repro_torch.launch.train`` per round
   on the kernel path (kernel 1 once a round), s/round and peak GB;
3. the ``train`` step kind's chunked engine (``build_step(...,
   scan_rounds=2)``: one round captured as a CUDA graph and replayed), three
   chunks of 2: warm-up, capture and instantiate seconds, the graph's pool
   GB, s/round a chunk, peak GB, and the device's busy share of one
   replayed chunk under ``torch.profiler``.

Every line carries the card's name and power limit.
"""

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH = "qwen3-0.6b"
N, T, B, S = 8, 4, 4, 64


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profiled(fn, label, card, top=8):
    """``fn()`` under torch.profiler: the wall, the device's busy ms and the
    top device operations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
          f"({100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels [{card}]")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"[profile]   {e.key[:72]:72s} calls={e.count:6d} "
              f"ms={e.self_device_time_total / 1e3:9.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_train_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import tree
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import fused_aggregate as fa
    from repro_torch.launch.train import train
    from repro_torch.models import build, common, count_params, transformer

    card = card_line()
    dev = torch.device("cuda")
    cfg = get_arch(ARCH).full()
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"[train] {ARCH} full(): {count_params(params):,} params, {cfg.dtype}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated [{card}]")

    # -- 1. one client step, unbind against indexing --------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    unbind = transformer.unstack_layers

    def indexed(stacked):
        n_layers = tree.leaves(stacked)[0].shape[0]
        return [common.layer_at(stacked, i) for i in range(n_layers)]

    def step():
        p = tree.map(lambda x: x.detach().requires_grad_(), params)
        leaves = tree.leaves(p)
        loss, _ = bundle.loss_fn(p, batch)
        return torch.autograd.grad(loss, leaves)

    grads = {}
    times = {"unbind": [], "index": []}
    peaks = {}
    for label in ("unbind", "index", "index", "unbind"):
        transformer.unstack_layers = unbind if label == "unbind" else indexed
        try:
            step()  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.steps):
                g = step()
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end) / args.steps)
            peaks[label] = (torch.cuda.max_memory_allocated() - held) / 1e9
            grads.setdefault(label, g)
            del g
            if len(times[label]) == 1:
                profiled(step, f"one client step ({label})", card)
        finally:
            transformer.unstack_layers = unbind
    same = all(torch.equal(a, b) for a, b in zip(grads["unbind"], grads["index"]))
    del grads
    for label in ("unbind", "index"):
        turns = [round(t, 2) for t in times[label]]
        print(f"[train] one client step ({label} the stacked layers), {B} x {S} tokens: "
              f"{statistics.mean(times[label]):.2f} ms (turns {turns}), peak "
              f"{peaks[label]:.2f} GB above the params [{card}]")
    print(f"[train] the two steps' gradients bitwise equal: {same}")

    # -- 2. the launcher per round, kernel path ---------------------------------
    base = ["--arch", ARCH, "--rounds", str(args.rounds), "--fused-kernel"]
    torch.cuda.reset_peak_memory_stats()
    fa.fused_aggregate_cuda.launches = 0
    res = train(base, params=params)
    per_round = [b["seconds"] for b in res.blocks]
    print(f"[train] per round, kernel path: s/round {[round(s, 3) for s in per_round]}, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, kernel 1 launches "
          f"{fa.fused_aggregate_cuda.launches}, loss {res.metrics['loss']} [{card}]")
    del res
    torch.cuda.empty_cache()

    # -- 3. chunks of 2: the train step kind's chunked engine ------------------
    from repro_torch import strategies
    from repro_torch.core import optimize_weights, topology
    from repro_torch.launch.steps import build_step
    from repro_torch.optim import sgd_momentum

    K = 2
    scan = build_step(bundle, "train", n_clients=N,
                      aggregation=strategies.get("colrel", fused="kernel"), scan_rounds=K)
    link = topology.fully_connected(N, 0.3, p_c=0.8)
    A = torch.as_tensor(np.asarray(optimize_weights(link, sweeps=20).A), dtype=torch.float32,
                        device=dev)
    rng = np.random.default_rng(0)
    tau_up = torch.as_tensor(rng.random((K, N)) < 0.3, dtype=torch.float32, device=dev)
    tau_dd = torch.as_tensor(rng.random((K, N, N)) < 0.8, dtype=torch.float32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (K, N, T, B, S + 1), generator=gen, device=dev)
    batches = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
    sstate = sgd_momentum(1.0, beta=0.9).init(params)
    torch.cuda.reset_peak_memory_stats()
    carry = (params, sstate, ())
    chunk_s = []
    for c in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        *carry, metrics = scan(*carry, batches, tau_up, tau_dd, A)
        torch.cuda.synchronize()
        chunk_s.append((time.perf_counter() - t) / K)
    st = scan.stats
    nodes = ctypes.c_size_t(0)
    ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(scan.graph.raw_cuda_graph()),
                                                None, ctypes.byref(nodes))
    print(f"[train] chunked K={K} (build_step train, scan_rounds): s/round by chunk "
          f"{[round(s, 4) for s in chunk_s]} (the first holds the warm-up and the capture), "
          f"warm-up {st['warmup_s']:.2f} s, capture {st['capture_s']:.2f} s, instantiate "
          f"{st['instantiate_s']:.2f} s, pool {st['pool_bytes'] / 1e9:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, captured launches "
          f"{st['captured_launches']}, {nodes.value} graph nodes, "
          f"loss {metrics['loss'].tolist()} [{card}]")
    profiled(lambda: scan(*carry, batches, tau_up, tau_dd, A), f"one replayed chunk of {K}",
             card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the reference package.  Phases,
each of which fails the run by raising:

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions and the TF32 settings the run uses;
2. build: the CUDA kernels with nvcc, into build/ (seconds and ptxas
   report printed);
3. kernels against their plain PyTorch versions on the card, at the
   shapes of the main path and at off-grid ones;
4. the main path at full width: three rounds of the paper's ColRel CNN
   experiment (cifar_cnn_full) through the fused kernel, again through the
   segment-streaming kernel and again through the collapse path, with the
   kernels' launch counts read around each run; the three runs must agree;
   then the quadratic task on the card against the port's CPU path;
5. times of each kernel at the main path's shapes beside its bound, its
   plain version and one PyTorch call computing the same product;
6. where one more round of the kernel path spends its time
   (torch.profiler): the device's busy share and the top operations.

The line before the last is a JSON object listing every ported kernel;
the last line is {"ok": true, "device": {...}}.
"""

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
HIDE_HOST_CYCLES = 4_000_000  # ~2 ms of device sleep, longer than any timed call's host enqueue
ROUNDS = 3
# One aggregation of the same stacked deltas: the kernel, segmented, collapse
# and faithful paths differ only in f32 summation order.
AGG_ATOL = 1e-6
# Params after 3 rounds: last-bit differences between the paths' deltas are
# amplified by training with TF32 convolutions (cuDNN's default); the
# segmented run repeats the kernel's arithmetic and is expected to be equal.
PARAM_ATOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, flush, reps):
    """Median device time of ``fn`` over ``reps`` calls, each timed by CUDA
    events with the L2 cache flushed before it (the stack arrives cold).
    A device-side sleep before the start event keeps the card busy while
    the host enqueues ``fn``, so the time is the device's and not the
    Python dispatch's (which the main path's s/round includes)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HIDE_HOST_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from repro_torch import tree
    from repro_torch.configs import colrel_paper
    from repro_torch.convert import params_from_jax
    from repro_torch.core import flatten
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_aggregate as fa
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import CNN

    dev = torch.device("cuda")
    # -- 1. device ---------------------------------------------------------
    card = card_line()
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"[device] tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.library()
    print(f"[build] {lib._name} in {time.perf_counter() - t0:.2f} s")
    for line in pathlib.Path(lib._name).with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # -- 3. kernels against their plain versions ---------------------------
    n = colrel_paper.full().n_clients
    full_shapes = flatten.flat_spec(CNN(colrel_paper.full().cnn).param_tree()).shapes
    full_sizes = [math.prod(s) for s in full_shapes]
    d_full = sum(full_sizes)
    check(len(full_sizes) == 61 and d_full == 272282, f"cifar_cnn_full layout {len(full_sizes)}, {d_full}")
    g = torch.Generator().manual_seed(0)

    def inputs(n_, d_, dtype):
        A = (torch.rand(n_, n_, generator=g) * 0.5 + 0.1).to(dev)
        tau_up = (torch.rand(n_, generator=g) < 0.7).float().to(dev)
        tau_dd = (torch.rand(n_, n_, generator=g) < 0.5).float().to(dev)
        X = torch.randn(n_, d_, generator=g)
        X = (X * 40).round().clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else X.to(dtype)
        return A, tau_up, tau_dd, X.to(dev)

    def err(got, want):
        check(got.shape == want.shape and got.dtype == torch.float32, "kernel output shape/dtype")
        e = (got - want).abs()
        check(bool(torch.all(e <= 1e-5 + 1e-5 * want.abs())), f"kernel disagrees: max abs {e.max()}")
        return float(e.max())

    max_err = {"fused_aggregate": 0.0, "row_stream": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for n_ in (4, 10, 33):
            for d_ in (1, 1000, 4099, d_full):
                A, tau_up, tau_dd, X = inputs(n_, d_, dtype)
                e = err(fa.fused_aggregate_cuda(A, tau_up, tau_dd, X),
                        fa.fused_aggregate_plain(A, tau_up, tau_dd, X))
                max_err["fused_aggregate"] = max(max_err["fused_aggregate"], e)
                print(f"[kernels] fused_aggregate {str(dtype)[6:]} n={n_} d={d_} max_abs_err={e:.3e}")
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        worst = 0.0
        A, tau_up, tau_dd, _ = inputs(n, 1, torch.float32)
        w = ops.collapsed_weight_row(A, tau_up, tau_dd) / (40 if dtype == torch.int8 else 1)
        for d_ in full_sizes:
            X = inputs(n, d_, dtype)[3]
            worst = max(worst, err(fa.row_stream_cuda(w, X), fa.row_stream_plain(w, X)))
        max_err["row_stream"] = max(max_err["row_stream"], worst)
        print(f"[kernels] row_stream {str(dtype)[6:]} over the 61 cifar_cnn_full segments "
              f"(d_i {min(full_sizes)}..{max(full_sizes)}) max_abs_err={worst:.3e}")
    A, tau_up, tau_dd, X = inputs(n, d_full, torch.float32)
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    segs = torch.cat([fa.row_stream_cuda(w, s.contiguous()) for s in X.split(full_sizes, dim=1)])
    mono = fa.fused_aggregate_cuda(A, tau_up, tau_dd, X)
    seg_err = float((segs - mono).abs().max())
    check(seg_err <= 1e-6, f"segmented vs monolithic kernel: {seg_err}")
    print(f"[kernels] segmented vs monolithic at n={n} d={d_full}: max_abs_err={seg_err:.3e}")
    torch.cuda.synchronize()

    # -- 4. the main path at full width ------------------------------------
    # one aggregation of cifar_cnn_full-shaped client deltas through every path
    from repro_torch import strategies
    from repro_torch.channel.base import StaticChannel
    from repro_torch.core import topology
    from repro_torch.core.weights import optimize_weights
    from repro_torch.strategies.base import ExecutionContext
    fig2b = topology.paper_fig2b()
    A = torch.as_tensor(optimize_weights(fig2b, sweeps=30, fine_tune_sweeps=30).A,
                        dtype=torch.float32, device=dev)
    tu, td = (torch.as_tensor(t, dtype=torch.float32, device=dev)
              for t in StaticChannel(fig2b, seed=0).tau_for_round(0))
    deltas = tree.map(lambda x: 1e-2 * torch.randn((n,) + tuple(x.shape), generator=g).to(dev),
                      CNN(colrel_paper.full().cnn).param_tree())
    ctx = ExecutionContext(n_clients=n)
    agg = {}
    for label, fused, c in (("kernel", "kernel", ctx), ("segmented", "kernel",
                            ExecutionContext(n_clients=n, segment_d=1)),
                            ("collapse", "collapse", ctx), ("faithful", False, ctx)):
        agg[label] = tree.leaves(strategies.get("colrel", fused=fused).aggregate_tree(
            deltas, tu, td, A, (), c)[0])
    for label in ("segmented", "collapse", "faithful"):
        diff = max(float((a - b).abs().max()) for a, b in zip(agg["kernel"], agg[label]))
        check(diff <= AGG_ATOL, f"one aggregation, kernel vs {label}: {diff}")
        print(f"[main] one aggregation of cifar_cnn_full deltas, kernel vs {label}: "
              f"max_abs_diff={diff:.3e} (atol {AGG_ATOL})")
    del deltas, agg

    def drive(options, segment_d):
        fa.fused_aggregate_cuda.launches = fa.row_stream_cuda.launches = 0
        exp = build_experiment(ExperimentSpec(model="cifar_cnn_full", strategy="colrel",
                                              strategy_options=options, segment_d=segment_d))
        secs = []
        for _ in range(ROUNDS):
            t = time.perf_counter()
            exp.run(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        counts = (fa.fused_aggregate_cuda.launches, fa.row_stream_cuda.launches)
        round_s[str(options["fused"]) + str(segment_d)] = secs
        loss = exp.log.loss
        check(all(math.isfinite(v) for v in loss), f"non-finite loss {loss}")
        leaves = tree.leaves(exp.params)
        check(len(leaves) == 61 and sum(x.numel() for x in leaves) == d_full
              and all(bool(torch.isfinite(x).all()) and x.is_cuda for x in leaves),
              "params: 61 finite CUDA leaves of d=272282")
        print(f"[main] fused={options['fused']!r} segment_d={segment_d}: loss={loss} "
              f"weight_sum={exp.log.weight_sums} launches(fused_aggregate, row_stream)={counts} "
              f"s/round={[round(s, 4) for s in secs]} [{card}]")
        return exp, counts

    round_s = {}
    kernel_exp, (fa_launches, rs0) = drive({"fused": "kernel"}, 0)
    check((fa_launches, rs0) == (ROUNDS, 0), f"monolithic run launches {(fa_launches, rs0)}")
    seg_exp, (fa0, rs_launches) = drive({"fused": "kernel"}, 1)
    check((fa0, rs_launches) == (0, ROUNDS * 61), f"segmented run launches {(fa0, rs_launches)}")
    col_exp, counts = drive({"fused": "collapse"}, 0)
    check(counts == (0, 0), f"collapse run launched a kernel {counts}")
    for name, other, atol in (("segmented", seg_exp, PARAM_ATOL), ("collapse", col_exp, PARAM_ATOL)):
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(tree.leaves(kernel_exp.params), tree.leaves(other.params)))
        check(diff <= atol, f"kernel vs {name} params differ by {diff}")
        print(f"[main] params kernel vs {name} after {ROUNDS} rounds: max_abs_diff={diff:.3e} "
              f"(atol {atol})")
        check(kernel_exp.log.participation == other.log.participation, "participation differs")

    # a small input against the port's CPU path (plain versions, no TF32)
    small = ExperimentSpec(model="quadratic", strategy="colrel", strategy_options={"fused": "kernel"})
    on_card, on_cpu = build_experiment(small), build_experiment(small, device="cpu")
    on_cpu.trainer.params = params_from_jax(tree.map(lambda x: x.cpu().numpy(), on_card.params), "cpu")
    on_card.run(2)
    on_cpu.run(2)
    for a, b in zip(on_card.log.loss, on_cpu.log.loss):
        check(abs(a - b) <= 1e-5 * abs(b), f"quadratic loss card {a} vs cpu {b}")
    qdiff = float((on_card.params["x"].cpu() - on_cpu.params["x"]).abs().max())
    check(qdiff <= 1e-5, f"quadratic params card vs cpu {qdiff}")
    print(f"[main] quadratic, card vs CPU path: losses {on_card.log.loss} vs {on_cpu.log.loss}, "
          f"params max_abs_diff={qdiff:.3e}")

    # -- 5. times at the main path's shapes --------------------------------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    A = kernel_exp.trainer.A
    tu, td = (torch.as_tensor(t, dtype=torch.float32, device=dev)
              for t in kernel_exp.trainer.channel.tau_for_round(0))
    X = torch.randn(n, d_full, device=dev)
    w = ops.collapsed_weight_row(A, tu, td)
    small_bytes = 4 * (2 * n * n + n)  # A, tau_dd, tau_up
    rows = []
    fa_times = dict(
        ms=median_ms(lambda: fa.fused_aggregate_cuda(A, tu, td, X), flush, 100),
        plain_ms=median_ms(lambda: fa.fused_aggregate_plain(A, tu, td, X), flush, 30),
        library_ms=median_ms(lambda: torch.matmul(w, X), flush, 100),
        bound_ms=bound_ms(small_bytes + 4 * n * d_full + 4 * d_full,
                          2 * n * d_full + 3 * n * n))
    rows.append(dict(name="fused_aggregate", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_aggregate.cu",
                     replaces="src/repro/kernels/fused_aggregate.py:60",
                     launches=fa_launches, max_abs_err=max_err["fused_aggregate"],
                     bound_by="bytes", **fa_times))
    segs = [s.contiguous() for s in X.split(full_sizes, dim=1)]
    rs_times = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for s in segs:
        rs_times["ms"] += median_ms(lambda: fa.row_stream_cuda(w, s), flush, 30)
        rs_times["plain_ms"] += median_ms(lambda: fa.row_stream_plain(w, s), flush, 10)
        rs_times["library_ms"] += median_ms(lambda: torch.matmul(w, s), flush, 30)
        rs_times["bound_ms"] += bound_ms(4 * n + 4 * n * s.shape[1] + 4 * s.shape[1],
                                         2 * n * s.shape[1])
    rows.append(dict(name="row_stream", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_aggregate.cu",
                     replaces="src/repro/kernels/fused_aggregate.py:105",
                     launches=rs_launches, max_abs_err=max_err["row_stream"],
                     bound_by="bytes", **rs_times))
    for r in rows:
        what = ("one launch, n=10 d=272282 f32" if r["name"] == "fused_aggregate"
                else "sum over the 61 segments of one round, n=10 f32")
        print(f"[time] {r['name']} ({what}): kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"[{card}]")
    torch.cuda.synchronize()

    # -- 6. where one round's time goes ------------------------------------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        kernel_exp.run(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # device-side events are the kernels themselves (host ops also carry
    # the device time of what they launched: summing both would count twice)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    plain_round_ms = 1e3 * statistics.median(round_s["kernel0"])
    print(f"[profile] one round of the kernel path under torch.profiler: wall {wall_ms:.1f} ms, "
          f"device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}% of the profiled "
          f"round, {100 * device_ms / plain_round_ms:.1f}% of the median unprofiled round "
          f"{plain_round_ms:.1f} ms), {sum(e.count for e in kernels)} kernels [{card}]")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"[profile] top device: {e.key[:70]:70s} calls={e.count:6d} "
              f"ms={e.self_device_time_total / 1e3:9.2f}")
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"[profile] top host: {e.key[:70]:70s} calls={e.count:6d} "
              f"ms={e.self_cpu_time_total / 1e3:9.2f}")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

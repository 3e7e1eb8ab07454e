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
   shapes of the main path and at off-grid ones: the ColRel aggregation
   kernels, the memory strategy's kernels (segment passes writing into
   strided views of one buffer, held to the monolithic kernel at 0) and
   the int8 dequant kernel;
4. the main path at full width: three rounds of the paper's ColRel CNN
   experiment (cifar_cnn_full) through the fused kernel, again through the
   segment-streaming kernel and again through the collapse path, with the
   kernels' launch counts read around each run; the three runs must agree;
   then the quadratic task on the card against the port's CPU path; then
   three rounds of the memory strategy under bursty (Markov) blockage and
   of the int8 quantized strategy, each through its kernel, its segment
   and its plain (fused=False) path, launches read around each run;
5. times of each kernel at the main path's shapes beside its bound, its
   plain version and one PyTorch call computing the same product where
   there is one;
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
# The memory and int8 quantized runs, kernel vs fused=False, params and the
# replay buffer after 3 rounds: the same amplification of last-bit
# differences, and for int8 stochastic rounding turns a sub-pitch difference
# in an update into a whole grid pitch (max|x_i| / 127) on some coordinates.
# One aggregation of identical inputs is held at AGG_ATOL above.
STRATEGY_PARAM_ATOL = 1e-3
N_LEAVES, D_FULL = 61, 272282  # cifar_cnn_full's parameter tree


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
    from repro_torch.kernels import fused_dequant as fdq
    from repro_torch.kernels import fused_memory as fm
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
    check(len(full_sizes) == N_LEAVES and d_full == D_FULL,
          f"cifar_cnn_full layout {len(full_sizes)}, {d_full}")
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

    max_err = dict.fromkeys(("fused_aggregate", "row_stream", "fused_memory_update",
                             "memory_stream", "fused_dequant_aggregate"), 0.0)
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

    def buffer_for(n_, d_):
        return torch.randn(n_, d_, generator=g).to(dev)

    for dtype in (torch.float32, torch.bfloat16):
        for n_ in (4, 10, 33):
            for d_ in (1, 1000, 4099, d_full):
                A, tau_up, tau_dd, X = inputs(n_, d_, dtype)
                B = buffer_for(n_, d_)
                B_plain = B.clone()
                got, got_buf = fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, B)
                want, want_buf = fm.fused_memory_update_plain(A, tau_up, tau_dd, X, B_plain)
                e = max(err(got, want), err(got_buf, want_buf))
                max_err["fused_memory_update"] = max(max_err["fused_memory_update"], e)
                print(f"[kernels] fused_memory_update {str(dtype)[6:]} n={n_} d={d_} "
                      f"max_abs_err={e:.3e} (delta and buffer)")
        # the 61 real segments, each pass writing into a strided column view
        # of one (n, d) buffer, against the plain version and the monolithic
        # kernel on the same inputs
        A, tau_up, tau_dd, X = inputs(n, d_full, dtype)
        B = buffer_for(n, d_full)
        mix = ops.mixing_mask(A, tau_dd)
        buf, plain_buf, mono_buf = B.clone(), B.clone(), B.clone()
        worst, deltas, off = 0.0, [], 0
        for d_ in full_sizes:
            seg = X[:, off:off + d_].contiguous()
            got, view = fm.memory_stream_cuda(mix, tau_up, seg, buf[:, off:off + d_])
            check(view.data_ptr() == buf[:, off:off + d_].data_ptr(), "memory_stream wrote a copy")
            want, _ = fm.memory_stream_plain(mix, tau_up, seg, plain_buf[:, off:off + d_])
            worst = max(worst, err(got, want))
            deltas.append(got)
            off += d_
        worst = max(worst, err(buf, plain_buf))
        max_err["memory_stream"] = max(max_err["memory_stream"], worst)
        mono, _ = fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, mono_buf)
        seg_err = max(float((torch.cat(deltas) - mono).abs().max()),
                      float((buf - mono_buf).abs().max()))
        check(seg_err == 0.0, f"segmented vs monolithic memory: {seg_err}")
        print(f"[kernels] memory_stream {str(dtype)[6:]} over the 61 segments into strided "
              f"buffer views: max_abs_err={worst:.3e} vs plain; segmented vs monolithic "
              f"(delta and buffer) max_abs_err={seg_err:.3e}")
    for n_ in (4, 10, 33):
        for d_ in (1, 1000, 4099, d_full):
            A, tau_up, tau_dd, q = inputs(n_, d_, torch.int8)
            scale = torch.rand(n_, 1, generator=g).to(dev) / 40
            e = err(fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, q, scale),
                    fdq.fused_dequant_aggregate_plain(A, tau_up, tau_dd, q, scale))
            max_err["fused_dequant_aggregate"] = max(max_err["fused_dequant_aggregate"], e)
            print(f"[kernels] fused_dequant_aggregate int8 n={n_} d={d_} max_abs_err={e:.3e}")
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
    # the memory round with a carried buffer (each path gets its own copy:
    # the kernel paths update it in place), and the int8 round from one
    # codec state (the kernel path and the dequant oracle draw the same q)
    buf0 = 1e-2 * torch.randn(n, d_full, generator=g).to(dev)
    seg_ctx = ExecutionContext(n_clients=n, segment_d=1)
    mem = {label: strategies.get("memory", fused=fused).aggregate_tree(
        deltas, tu, td, A, buf0.clone(), c)
        for label, fused, c in (("kernel", "kernel", ctx), ("segmented", "kernel", seg_ctx),
                                ("fused=False", False, ctx))}
    quant = {label: strategies.get("quantized", codec="int8", fused=fused).aggregate_tree(
        deltas, tu, td, A, ((0, 0), ()), ctx)[0]
        for label, fused in (("kernel", "kernel"), ("fused=False", False))}
    for what, label, got, want, atol in (
            ("memory delta", "segmented", mem["segmented"][0], mem["kernel"][0], 0.0),
            ("memory buffer", "segmented", [mem["segmented"][1]], [mem["kernel"][1]], 0.0),
            ("memory delta", "fused=False", mem["fused=False"][0], mem["kernel"][0], AGG_ATOL),
            ("memory buffer", "fused=False", [mem["fused=False"][1]], [mem["kernel"][1]], AGG_ATOL),
            ("int8 quantized delta", "fused=False", quant["fused=False"], quant["kernel"], AGG_ATOL)):
        diff = max(float((a - b).abs().max()) for a, b in zip(tree.leaves(got), tree.leaves(want)))
        check(diff <= atol, f"one aggregation, {what}, kernel vs {label}: {diff}")
        print(f"[main] one aggregation of cifar_cnn_full deltas, {what}, kernel vs {label}: "
              f"max_abs_diff={diff:.3e} (atol {atol})")
    del deltas, agg, mem, quant, buf0

    wrappers = {"fused_aggregate": fa.fused_aggregate_cuda, "row_stream": fa.row_stream_cuda,
                "fused_memory_update": fm.fused_memory_update_cuda,
                "memory_stream": fm.memory_stream_cuda,
                "fused_dequant_aggregate": fdq.fused_dequant_aggregate_cuda}

    def drive(label, strategy, options, segment_d, *, channel="static", expect):
        """Three rounds of one path with every launch count set to 0 just
        before and read just after; ``expect`` names the kernels the path
        must have launched and how often, every other count must be 0."""
        for w in wrappers.values():
            w.launches = 0
        exp = build_experiment(ExperimentSpec(model="cifar_cnn_full", strategy=strategy,
                                              strategy_options=options, segment_d=segment_d,
                                              channel=channel))
        secs = []
        for _ in range(ROUNDS):
            t = time.perf_counter()
            exp.run(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        counts = {k: w.launches for k, w in wrappers.items()}
        round_s[label] = secs
        loss = exp.log.loss
        check(all(math.isfinite(v) for v in loss), f"{label}: non-finite loss {loss}")
        leaves = tree.leaves(exp.params)
        check(len(leaves) == N_LEAVES and sum(x.numel() for x in leaves) == d_full
              and all(bool(torch.isfinite(x).all()) and x.is_cuda for x in leaves),
              f"{label}: params are not {N_LEAVES} finite CUDA leaves of d={d_full}")
        launched = {k: v for k, v in counts.items() if v}
        print(f"[main] {label}: {strategy} {options} segment_d={segment_d} channel={channel}: "
              f"loss={loss} participation={exp.log.participation} "
              f"uplink_bits={exp.log.uplink_bits} weight_sum={exp.log.weight_sums} "
              f"launches={launched} s/round={[round(x, 4) for x in secs]} [{card}]")
        check(launched == expect, f"{label}: launches {launched}, expected {expect}")
        return exp, counts

    def max_diff(xs, ys):
        return max(float((a - b).abs().max()) for a, b in zip(xs, ys))

    def compare(label, ref, others):
        """Params (and the replay buffer, where the strategy carries one) of
        ``ref`` against each other run."""
        for name, other, atol in others:
            diffs = {"params": max_diff(tree.leaves(ref.params), tree.leaves(other.params))}
            if isinstance(ref.trainer.agg_state, torch.Tensor):
                diffs["replay buffer"] = max_diff([ref.trainer.agg_state],
                                                  [other.trainer.agg_state])
            for what, diff in diffs.items():
                check(diff <= atol, f"{label} vs {name}: {what} differ by {diff}")
                print(f"[main] {label} vs {name} after {ROUNDS} rounds: {what} "
                      f"max_abs_diff={diff:.3e} (atol {atol})")
            check(ref.log.participation == other.log.participation,
                  f"{label} vs {name}: participation differs")

    round_s = {}
    kernel_exp, counts = drive("colrel kernel", "colrel", {"fused": "kernel"}, 0,
                               expect={"fused_aggregate": ROUNDS})
    fa_launches = counts["fused_aggregate"]
    seg_exp, counts = drive("colrel segmented", "colrel", {"fused": "kernel"}, 1,
                            expect={"row_stream": ROUNDS * N_LEAVES})
    rs_launches = counts["row_stream"]
    col_exp, _ = drive("colrel collapse", "colrel", {"fused": "collapse"}, 0, expect={})
    compare("colrel kernel", kernel_exp, (("segmented", seg_exp, PARAM_ATOL),
                                          ("collapse", col_exp, PARAM_ATOL)))

    # the memory strategy under bursty blockage: kernel, segments, plain path
    mem_exp, counts = drive("memory kernel", "memory", {"fused": "kernel"}, 0, channel="markov",
                            expect={"fused_memory_update": ROUNDS})
    fmu_launches = counts["fused_memory_update"]
    mem_seg, counts = drive("memory segmented", "memory", {"fused": "kernel"}, 1,
                            channel="markov", expect={"memory_stream": ROUNDS * N_LEAVES})
    ms_launches = counts["memory_stream"]
    mem_plain, _ = drive("memory plain", "memory", {"fused": False}, 0, channel="markov",
                         expect={})
    compare("memory kernel", mem_exp, (("segmented", mem_seg, 0.0),
                                       ("fused=False", mem_plain, STRATEGY_PARAM_ATOL)))
    check(min(mem_exp.log.participation) < n,
          f"memory: every uplink arrived in every round {mem_exp.log.participation}; "
          "the replay branch never ran")

    # int8 quantized relaying: fused dequant kernel, int8 segments through
    # row_stream (ops.dequant_row_stream admits int8 segments only), and the
    # dequant oracle, which draws the kernel path's codec stream
    q_opts = {"codec": "int8", "fused": "kernel"}
    q_exp, counts = drive("quantized kernel", "quantized", q_opts, 0,
                          expect={"fused_dequant_aggregate": ROUNDS})
    fdq_launches = counts["fused_dequant_aggregate"]
    q_seg, counts = drive("quantized segmented", "quantized", q_opts, 1,
                          expect={"row_stream": ROUNDS * N_LEAVES})
    q_plain, _ = drive("quantized plain", "quantized", {"codec": "int8", "fused": False}, 0,
                       expect={})
    compare("quantized kernel", q_exp, (("fused=False", q_plain, STRATEGY_PARAM_ATOL),))
    check(q_seg.log.participation == q_exp.log.participation
          and q_seg.log.uplink_bits == q_exp.log.uplink_bits,
          "quantized segmented: participation or uplink_bits differ")
    check(all(abs(b - p * (8 * d_full + 32)) <= 1e-6 * b
              for b, p in zip(q_exp.log.uplink_bits, q_exp.log.participation)),
          f"quantized uplink_bits {q_exp.log.uplink_bits}")
    print("[main] quantized segmented draws another codec realization: held to finite params, "
          "the kernel path's participation and uplink_bits (8 + 32/d bits per coordinate)")

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
    # row_stream on the quantized path's int8 segments
    q8 = (X * 40).round().clamp(-127, 127).to(torch.int8)
    scale = torch.rand(n, 1, device=dev) / 40
    ws = ops.fold_dequant_scales(w, scale)
    q8_segs = [s_.contiguous() for s_ in q8.split(full_sizes, dim=1)]
    rs8_ms = sum(median_ms(lambda: fa.row_stream_cuda(ws, s_), flush, 30) for s_ in q8_segs)
    rs8_bound = sum(bound_ms(4 * n + n * s_.shape[1] + 4 * s_.shape[1], 2 * n * s_.shape[1])
                    for s_ in q8_segs)

    # the memory kernels: X and B read, contrib and delta written
    def mem_bytes(d_):
        return 12 * n * d_ + 4 * d_

    def mem_ops(d_):
        return 2 * n * n * d_ + 4 * n * d_

    B = torch.randn(n, d_full, device=dev)
    mix = ops.mixing_mask(A, td)
    no_library = ("null: no single PyTorch call computes tilde, the select, the row mean "
                  "and the buffer update")
    fmu_times = dict(
        ms=median_ms(lambda: fm.fused_memory_update_cuda(A, tu, td, X, B), flush, 100),
        plain_ms=median_ms(lambda: fm.fused_memory_update_plain(A, tu, td, X, B), flush, 30),
        library_ms=None,
        bound_ms=bound_ms(small_bytes + mem_bytes(d_full), mem_ops(d_full)))
    tilde_ms = median_ms(lambda: torch.matmul(mix, X), flush, 100)
    rows.append(dict(name="fused_memory_update", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_memory.cu",
                     replaces="src/repro/kernels/fused_memory.py:63",
                     launches=fmu_launches, max_abs_err=max_err["fused_memory_update"],
                     bound_by="bytes", **fmu_times))
    ms_times = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0)
    tilde_seg_ms, off = 0.0, 0
    for s_ in segs:
        d_ = s_.shape[1]
        view = B[:, off:off + d_]
        ms_times["ms"] += median_ms(lambda: fm.memory_stream_cuda(mix, tu, s_, view), flush, 30)
        ms_times["plain_ms"] += median_ms(lambda: fm.memory_stream_plain(mix, tu, s_, view),
                                          flush, 10)
        ms_times["bound_ms"] += bound_ms(4 * n * n + 4 * n + mem_bytes(d_), mem_ops(d_))
        tilde_seg_ms += median_ms(lambda: torch.matmul(mix, s_), flush, 30)
        off += d_
    rows.append(dict(name="memory_stream", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_memory.cu",
                     replaces="src/repro/kernels/fused_memory.py:118",
                     launches=ms_launches, max_abs_err=max_err["memory_stream"],
                     bound_by="bytes", **ms_times))

    # the dequant kernel: the int8 stack read, the (d,) delta written
    fdq_times = dict(
        ms=median_ms(lambda: fdq.fused_dequant_aggregate_cuda(A, tu, td, q8, scale), flush, 100),
        plain_ms=median_ms(lambda: fdq.fused_dequant_aggregate_plain(A, tu, td, q8, scale),
                           flush, 30),
        library_ms=None,
        bound_ms=bound_ms(small_bytes + 4 * n + n * d_full + 4 * d_full,
                          2 * n * d_full + 4 * n * n))
    two_calls_ms = median_ms(lambda: torch.matmul(ws, q8.float()), flush, 100)
    rows.append(dict(name="fused_dequant_aggregate", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_aggregate.cu",
                     replaces="src/repro/kernels/fused_dequant.py:67",
                     launches=fdq_launches, max_abs_err=max_err["fused_dequant_aggregate"],
                     bound_by="bytes", **fdq_times))

    whats = {
        "fused_aggregate": "one launch, n=10 d=272282 f32",
        "row_stream": "sum over the 61 segments of one round, n=10 f32",
        "fused_memory_update": "one launch, n=10 d=272282 f32 stack and buffer",
        "memory_stream": "sum over the 61 segments of one round, n=10 f32, strided buffer views",
        "fused_dequant_aggregate": "one launch, n=10 d=272282 int8",
    }
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {r['name']} ({whats[r['name']]}): kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} [{card}]")
    print(f"[time] row_stream on the quantized path's 61 int8 segments (sum): kernel "
          f"{rs8_ms:.4f} ms, bound {rs8_bound:.4f} ms (bytes) [{card}]")
    print(f"[time] memory kernels' library_ms is {no_library}; yardstick of tilde alone, "
          f"torch.matmul(mix, X): {tilde_ms:.4f} ms one launch, {tilde_seg_ms:.4f} ms summed "
          f"over the 61 segments [{card}]")
    print(f"[time] fused_dequant_aggregate's library_ms is null: no single PyTorch call "
          f"takes the int8 stack; two calls, torch.matmul(ws, q.float()): {two_calls_ms:.4f} ms "
          f"[{card}]")
    for label, secs in round_s.items():
        print(f"[time] s/round {label}: {[round(x, 4) for x in secs]}, median of rounds 2-{ROUNDS} "
              f"{statistics.median(secs[1:]):.4f} [{card}]")
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
    plain_round_ms = 1e3 * statistics.median(round_s["colrel kernel"])
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

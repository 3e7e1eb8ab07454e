#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the reference package.  Phases,
each of which fails the run by raising:

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions and the TF32 settings the run uses;
2. build: the CUDA kernels with nvcc, into build/ (seconds, and ptxas's
   registers, spills and shared memory for every kernel printed);
3. kernels against their plain PyTorch versions on the card, at the
   shapes of the main path and at off-grid ones: the ColRel aggregation
   kernels (kernels 1 and 6 bitwise, from n = 1 to 4096, across the
   collapse's load batches), the memory strategy's kernels (segment passes writing into
   strided views of one buffer, held to the monolithic kernel at 0), the
   int8 dequant kernel, and bitwise: the grouped launches of kernels 2
   (f32, bf16, int8) and 5 (f32, bf16) over the 61 cifar_cnn_full segments
   against their plain versions, the per-segment and the monolithic
   kernels; the clustered kernels (block relay
   mix, block aggregation, block row stream) up to n = 16,384 as 256
   clusters of 64, the dense relay mix, the clustered kernels at C = 1
   against the dense ones, and block segments against the monolithic
   pass; the grouped launch of kernel 9 (f32, bf16) over the 61 segments
   against its plain version, the per-segment kernel 9 and kernel 8, at
   C = 1 against the grouped kernel 2, and at n = 16,384, bitwise;
4. the main path at full width: three rounds of the paper's ColRel CNN
   experiment (cifar_cnn_full) through the fused kernel, again through the
   segment-streaming kernel and again through the collapse path, with the
   kernels' launch counts read around each run; the three runs must agree;
   then the quadratic task on the card against the port's CPU path; then
   three rounds of the memory strategy under bursty (Markov) blockage and
   of the int8 quantized strategy, each through its kernel, its segment
   and its plain (fused=False) path, launches read around each run (the
   segmented colrel, memory, quantized and clustered paths launch their
   grouped kernel once a round); the
   relay mixes through their entry points (ops.relay_mix at the kernel
   benchmark's n=16, d=2^20, ops.block_relay_mix on cifar_cnn_full
   deltas); three rounds of clustered relaying of cifar_cnn_full (n=10 as
   2 clusters of 5, an FLTrainer given a clustered channel and per-cluster
   COPT-alpha weights) through the block kernel, the block segments, the
   collapse and the faithful path, and once more through the kernel under
   clustered bursty blockage; and three rounds of the population path
   (n=1024 as 64 clusters of 16, the D=64 quadratic), kernel against
   fused=False;
4b. the chunked engine (``run(rounds, chunk=K)``): every kernel path of
   phase 4 (colrel kernel, segmented and collapse; memory kernel and
   segmented; int8 quantized kernel and segmented; clustered kernel and
   segmented; the n=1024 population) once more from the same init as one
   chunk of three rounds, one round captured as a CUDA graph and replayed
   three times, held bitwise to its per-round run (params, server state,
   strategy state, per-round metrics), with its kernel launches a chunk
   (captured a round x replays), warm-up, capture and instantiate
   seconds, graph nodes and memory; then the colrel kernel path's s/round
   per round and chunked (K=4) in turns, one replayed chunk under
   torch.profiler (the device's busy share, and the aggregation kernel's
   launches in the trace against captured x replays); and one chunk with
   the taus drawn inside the captured round (``no_trace=True``) on the
   static and the Markov channel;
4c. the other round modes and async relaying, on cifar_cnn_full at the
   paper's widths from one init: three rounds of client_sequential held to
   phase 4's per_client collapse run, and of weighted_grad at T=1 held to
   per_client at T=1 (participation, uplink_bits and weight_sum equal,
   params within MODE_REL_L2), each once more as one chunk of three,
   bitwise; three rounds of async colrel under Markov blockage (T=1)
   through the kernel (kernel 1 once a round), segmented (kernel 2 once a
   round, over the whole staging buffer) and plain paths, ages and
   staleness metrics bitwise equal across them, each once more as one
   chunk and with no_trace, bitwise with all 8 metrics; a zero-blockage
   round bitwise equal to sync colrel's; three async rounds of the n=1024
   population through kernel 8; seconds a round per round and chunked
   (K=4) of client_sequential, weighted_grad (T=1), per_client (T=1) and
   the async kernel path (T=8) beside phase 4b's colrel kernel path; and
   weighted_flat against weighted_grad on jamba's smoke config without
   experts, one round;
4d. the mmWave mobility channel with adaptive alpha, multihop relaying and
   the sparsifying codecs, on cifar_cnn_full at the paper's widths from one
   init, the checks at T=1 (the channel, the estimator and the aggregation
   do not depend on T): eight rounds of mobility with adaptive
   re-optimization every 4 rounds (a blind start alpha) through the kernel
   (kernel 1 once a round), segmented (kernel 2's grouped launch once a
   round) and collapse paths, which see the same taus (the estimator's
   posterior and the clients' positions bitwise), re-optimize at rounds 3
   and 7 to the same S_est and the same alpha, and end within PARAM_ATOL;
   the kernel path again as 2 chunks of 4, bitwise its per-round run with
   both alpha swaps, from one capture; four rounds of mobility_fast with
   oracle COPT-alpha of the channel's round-0 model through kernel 1;
   three rounds of calibrated multihop (K=2), per round and as one chunk,
   bitwise, and K=1 bitwise colrel's collapse; three rounds each of
   quantized topk (fraction 0.1) and randk (0.25), per round and as one
   chunk, bitwise, with uplink_bits as the codec's descriptor gives them;
   no_trace on mobility raising ValueError; then s/round at T=8 per round
   and chunked (K=4) of the adaptive mobility kernel path in turns with
   the colrel kernel path, and the host seconds of one re-optimization;
4e. telemetry and checkpoint/resume, on cifar_cnn_full at the paper's
   widths from one init, the checks at T=1 (the streak, the vectors and the
   carry do not depend on T): the colrel kernel path with telemetry on, 4
   rounds per round and as one chunk of 4, bitwise the telemetry-off
   per-round run (every scalar, params, server and strategy state), the
   chunk bitwise the per-round run with the vectors and the int32 streak,
   which follow the recurrence; then 8 rounds in chunks of 4 with
   telemetry and a checkpoint every chunk on the memory kernel path under
   Markov blockage (kernel 4), int8 quantized (kernel 6, the codec's
   generator on the card) and colrel no_trace on Markov (the sampler's
   CUDA generator): a fresh trainer
   resumed at round 4 ends bitwise the uninterrupted run, from one capture,
   and the uninterrupted trainer, which has captured, restored at round 4
   does so again without capturing; the checkpoints' bytes, the loop's
   blocked and the writer's commit seconds, the resumed first chunk's
   warm-up and capture; then s/round at T=8 chunked (K=4) of the colrel
   kernel path with telemetry off, on, and off with a checkpoint every
   chunk, in turns;
5. times of each kernel at the main path's shapes beside its bound, its
   plain version and one PyTorch call computing the same product where
   there is one; kernels 2, 5 and 9 as the segmented paths launch them, one
   grouped call over the 61 segments, beside the sum of their 61
   per-segment launches each timed alone (per_segment_ms); kernel 6 beside
   an empty kernel of its grid (floor_ms), kernel 2's launch on the same
   int8 stack with the folded row given (no_collapse_ms) and a device copy
   of the stack (copy_ms), with its grid;
6. where one more round of the kernel path spends its time
   (torch.profiler): the device's busy share and the top operations;
7. serving seamless-m4t-large-v2 at full width (24 + 24 layers, d_model
   1024, bf16, the port's own init from a seed): the prefill step on 4
   requests of 960 frames and a 4096-token prompt through the flash
   kernel (24 launches a prefill, counted), its time and peak memory,
   against the plain path at a depth cut (see PREFILL_TOL); then the
   serving CLI's path on 4 requests (64-token prompt replayed through the
   serve step, 32 greedy tokens), with prefill-vs-replay consistency at a
   depth cut;
8. kernel 10 (causal flash attention) timed at the seamless prefill shape
   beside its bound, its plain version and PyTorch's
   scaled_dot_product_attention; then at jamba's prefill shape (64 query
   heads over 8 kv heads, D=128) through ops.flash_attention on strided
   views of one fused QKV tensor, checked to allocate only its output,
   held to the plain version on one kv group, and timed beside its bound
   and scaled_dot_product_attention with enable_gqa;
9. serving jamba-1.5-large-398b at full width and one period (8 layers: 1
   attention with 64 query heads over 8 kv heads, 7 Mamba; dense SwiGLU
   MLPs, no experts; bf16, the port's own init from a seed; the seamless
   params freed first): the prefill step on 4 requests of 4096 tokens (1
   flash_attention and 7 ssd_scan launches a prefill, counted), its time
   and peak memory, and the plain path's; every mixer of the period
   through its kernel against its plain version on the same input; the
   serving CLI's path on 4 requests (128-token prompt replayed through the
   serve step, 32 greedy tokens); a profile of a prefill and of decode
   steps; then in f32 the whole period at 1 x 1024, kernel path against
   plain path, and the served prompt's prefill against its replay;
10. kernel 11 (the chunked SSD recurrence) timed at the prefill shape
   beside its bound and its plain version, on contiguous operands and on
   the Mamba mixer's views, which are also held to the plain version;
11. serving the rest of the model zoo (see ZOO): olmo-1b, qwen3-0.6b,
   gemma3-1b, internvl2-2b, granite-moe-3b-a800m and rwkv6-1.6b at full
   width and full depth in bf16 (the port's own init from a seed, each
   model's params freed before the next): the prefill step on 4 requests
   of 1024 tokens (internvl2 with 1024 synthetic patches in front), no
   hand-written kernel launched (counted), its time and peak memory, a
   MoE's dropped assignments; the serving CLI's path on 4 requests
   (32-token prompt replayed, 16 greedy tokens); then in f32 at depth 2
   (full width) the prefill against the prompt replayed through the serve
   step (64 tokens, gemma3 640, past its window) at atol = rtol = 2e-2,
   with 0 dropped assignments required; then jamba at one period with 4
   of its 16 experts: the prefill on 1 x 1024 (1 flash_attention and 7
   ssd_scan launches, counted), its peak memory, 8 decode steps, and the
   f32 check on the period's first two layers (attention, Mamba + MoE);
12. training the zoo through the launcher (``repro_torch.launch.train``,
   the CLI's defaults: 8 clients, 4 local steps, 4 x 64 tokens, per_client
   ColRel rounds over a fully connected topology with COPT-alpha weights):
   qwen3-0.6b at full width and depth in bf16 from one init, 3 rounds each
   through the collapse, the kernel (kernel 1 once a round, counted) and
   the segmented path (kernel 2's grouped launch once a round, counted),
   the three agreeing (see TR_LOSS_RTOL, TR_PARAM_REL), with s/round and
   peak memory; the kernel path once more as one chunk of 2 (one round
   captured and replayed), bitwise its per-round run's first two rounds,
   with the graph's pool and the peak; kernels 1 and 2 timed at qwen3's
   (8, d) beside their bounds, plain versions and ``w @ X``, each held
   bitwise to its plain version there; and each of the ten arch ids at
   --smoke for 2 rounds, while tools/torch_kill_resume_smoke.py runs at
   --smoke on the card in its own processes (16 rounds in chunks of 4,
   SIGTERM after chunk 2, --resume, rounds.csv byte-equal);
13. the one-card dry run and the examples (see DR_*, EST_*, EXAMPLES):
   ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b`` on prefill_32k
   and decode_32k in processes of their own on the host (fake tensors; each
   record's FLOPs, unfused bytes, peak and roofline terms printed); the
   dry run's estimate held against the card for qwen3-0.6b at full width
   cut to 2 layers, the train, prefill and decode kinds each traced on fake
   tensors and run on the card (FLOPs equal, the fake peak within 10% of
   the card's); and the three ``examples/*_torch.py`` at small settings on
   the card, each exiting 0.

Phase 3 also holds kernel 10 against its plain version at (BH, T, D) in
{(2, 128, 64), (8, 256, 32), (2, 192, 128), (64, 1024, 64)}, f32 and
bf16, and through the GQA entry point (16 query heads over 8 kv heads);
and kernel 11 at (BH, T, Dk, Dv) in {(2, 128, 8, 16), (1, 64, 4, 4),
(3, 96, 16, 32)} with chunks of 16 and 32, and at the jamba prefill's
(1024, 4096, 16, 64) with chunks of 64, f32 and bf16, and in bf16 once
more with decays 16 times slower (a state that lives across chunks).  In
bf16 each (slice, chunk) and each slice of kernel 11's output is also held
by relative L2 (SSD_CHUNK_TOL, SSD_SLICE_TOL), here and on the Mamba views
of phase 10.

The line before the last is a JSON object listing every ported kernel;
the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.launch.roofline import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S  # noqa: E402
HIDE_HOST_CYCLES = 4_000_000  # ~2 ms of device sleep, longer than any timed call's host enqueue
ROUNDS = 3
# rounds a chunk of the timed chunked engine (phase 4b)
CHUNK_K = 4
# One aggregation of the same stacked deltas: the kernel, segmented, collapse
# and faithful paths differ only in f32 summation order.
AGG_ATOL = 1e-6
# The population path (n=1024, the D=64 quadratic, no convolutions) after 3
# rounds, kernel vs fused=False: 1024-term f32 sums in two orders.
POP_ATOL = 1e-5
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
# Phase 4c: client_sequential against per_client's collapse (T=8), and
# weighted_grad against per_client at T=1, params after 3 rounds by
# relative L2.  The modes sum the same client deltas or gradients in
# another order (and weighted_grad applies the weight decay once where the
# collapse weights it by the realized weight sum, 1e-4 x lr x (sum w - 1)
# of the params a round).  On the CPU (one thread, no TF32) at
# cifar_cnn_full they read 3.3e-6 and 5.2e-6 (tools/mode_agreement.py);
# the limit is ~100x the larger, for TF32 convolutions' amplification of
# last-bit differences on the card.
MODE_REL_L2 = 5e-4
# async relaying in phase 4c: gamma 0.8 without the relay rescue, so that
# the ages grow under fig2b's Markov blockage; its checks at T = 1 (the
# async carry and aggregation do not depend on T; T = 8 would take 8x the
# local SGD of the eleven async runs), its timing at T = 8
ASYNC_OPTIONS = {"gamma": 0.8, "opportunistic": False}
# phase 4d: adaptive mobility re-optimizes every MOB_REOPT rounds (after
# a warm-up of as many), MOB_ROUNDS rounds a run: two re-opts, the second on
# the last round; its chunks are MOB_REOPT rounds, one re-opt a chunk
MOB_REOPT, MOB_ROUNDS = 4, 8
# Kernel 10 against its plain version (the dense softmax): the reference's
# bound for its kernel in f32 (tests/test_kernels.py:52), and 2e-2 in bf16
# (the output is rounded to bf16 on both sides), compared in f32.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 kernel 10 per (head, 128-row block), relative L2 against the plain
# version: one bf16 ulp (2^-8) on every element of the block.  The output
# is rounded to bf16 on both sides, so a sound kernel differs by single-ulp
# flips in a fraction of the elements; a stale or skipped kv tile errs by
# percents in the rows it touches.
FLASH_BLOCK_TOL = 2.0**-8
SEAMLESS = "seamless-m4t-large-v2"
# prefill cut from prefill_32k's 32 x 32768 (the reference's unchunked
# cross-attention logits alone would be 64 GB there); serving as the
# reference's serve_decode example does it, at 4 requests
PF_B, PF_T = 4, 4096
SV_B, SV_P, SV_G = 4, 64, 32
# decode steps profiled (phase 7), cut from the prompt's 64: reducing the
# trace of 64 steps (~236k kernels and their host events) took ~170 s
SV_PROF = 8
# Full-width seamless under the zoo's init (projections scaled by the
# fan-in shape[-2], the head count for wq) has attention logits of standard
# deviation ~64: the softmaxes are nearly one-hot and a near-tie flips on a
# last-bit difference, so two exact computations of the same model
# decorrelate with depth, by ~10x a layer, the reference's own paths as
# well as the port's (tools/depth_probe.py measures both).  At all 24
# layers the last logits of the flash and the plain path are ~1.2 apart
# (relative L2) in f32 and bf16 alike.  So the paths are compared on the same params cut to
# their first CMP_DEPTH encoder and decoder layers (full width, the same
# shapes), by relative L2 of the last logits: 1e-3 in f32 (the flash and
# chunked paths' f32 sums in other orders), 2e-2 in bf16 (about ten bf16
# roundings of 2^-9).  The bf16 decode replay rounds its one-token
# projections differently from the prefill's, so its bf16 check is at depth
# 1; f32 at CMP_DEPTH.
CMP_DEPTH = 2
PREFILL_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# Kernel 11 against its plain version: the reference's bound for its kernel
# in f32 (tests/test_kernels.py:96), 2e-2 in bf16 (the output is rounded to
# bf16 on both sides), compared in f32; both compute in f32 and sum the
# products in another order.
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
# bf16 kernel 11 by relative L2 against its plain version, per (slice,
# chunk) and per slice.  Both outputs are rounded to bf16, so a sound kernel
# differs by single-ulp flips in a fraction of the elements.  Per chunk: one
# bf16 ulp (2^-8) on every element, which a stale or skipped chunk, state
# or tile passes by far.  Per slice: the elementwise SSD_TOL cannot tell
# the kernel's hi + lo split products (~16 bits) from hi-only ones (~8
# bits); this limit lies between the kernel's readings (at most 2.3e-4)
# and those of copies with one of its three splits (W, S, k * decay) cut to
# the hi part (at least 3.7e-4 at the prefill shape, 1.6e-3 there with slow
# decays; tools/ssd_split_probe.py, NVIDIA H100 80GB HBM3).
SSD_CHUNK_TOL = 2.0**-8
SSD_SLICE_TOL = 3e-4
JAMBA = "jamba-1.5-large-398b"
# jamba at full width, one period (1 attention + 7 Mamba layers, dense MLPs:
# depth 72 -> 8, moe_every 2 -> 0); the prefill cut from prefill_32k's 32 x
# 32768 to 4 x 4096 (the plain path's chunked attention logits alone would
# be 34 GB a chunk at T = 32768), whose (B*H, T, Dk, Dv) SSD shape is
# SSD_PREFILL_SHAPE; the serving path at 4 requests, a 128-token prompt
# replayed, 32 greedy tokens; the whole period in f32 at 1 x 1024
JB_B, JB_T = 4, 4096
SSD_PREFILL_SHAPE = (JB_B * 256, JB_T, 16, 64)
JB_SV_P, JB_SV_G = 128, 32
JB_F32_T = 1024
# Phase 11: the rest of the zoo at full width and full depth in bf16 (the
# port's own init from a seed), each model's params freed before the next
# one's are drawn.  The prefill cut from prefill_32k's 32 x 32768 to
# ZOO_B x ZOO_T (gemma3's 512-token window is passed); the serving CLI's
# path on ZOO_B requests, a ZOO_SV_P-token prompt replayed through the
# serve step, then ZOO_SV_G greedy tokens.
ZOO = ("olmo-1b", "qwen3-0.6b", "gemma3-1b", "internvl2-2b", "granite-moe-3b-a800m",
       "rwkv6-1.6b")
ZOO_B, ZOO_T = 4, 1024
ZOO_SV_P, ZOO_SV_G = 32, 16
# jamba with its experts: one period (depth 72 -> 8) and 16 -> 4 experts
# (top-2 kept), ~16 B params, ~32 GB in bf16; the prefill on 1 x JE_T
# tokens, then JE_STEPS decode steps
JE_T, JE_STEPS = 1024, 8
# Prefill against the prompt replayed through the serve step, in f32 at
# full width cut to its first ZOO_CMP_DEPTH layers (jamba: the period's
# first two, attention + dense MLP and Mamba + MoE), ZOO_B requests of
# ZOO_CMP_P tokens (gemma3: past its window, so that decode masks it too);
# atol = rtol = ZOO_CMP_TOL, tests/test_decode_consistency.py's bar for the
# reference.  A MoE's prefill and its decode steps see other capacities,
# so they agree only when no assignment is dropped: every dropped count
# there must be 0.
ZOO_CMP_DEPTH = 2
ZOO_CMP_P = {"gemma3-1b": 640}
ZOO_CMP_P_DEFAULT = 64
ZOO_CMP_TOL = 2e-2
# Phase 12: qwen3-0.6b at full width trained through the launcher with its
# CLI defaults, TR_ROUNDS rounds a path from one init; the kernel path again
# as one chunk of TR_CHUNK rounds; the ten arch ids at --smoke for
# TR_SMOKE_ROUNDS rounds.  The collapse and the kernel paths sum the same
# client deltas in another order (f32), and the bf16 params round the
# updates: a last-bit difference in an update flips a bf16 rounding now
# and then, and training carries it on.  The paths are held per round by
# loss (rtol TR_LOSS_RTOL) and after TR_ROUNDS rounds by the relative L2
# of the whole param tree (TR_PARAM_REL), about a quarter of one bf16 ulp
# (2^-8) spread over every param; the segmented path repeats the kernel's
# arithmetic.
TR_ARCH = "qwen3-0.6b"
TR_ROUNDS, TR_CHUNK, TR_SMOKE_ROUNDS = 3, 2, 2
# tools/torch_kill_resume_smoke.py in phase 12: rounds and chunk (the tool's
# own defaults, 32 and 8, take ~43 s on the card)
TR_KILL_ROUNDS, TR_KILL_CHUNK = 16, 4
TR_LOSS_RTOL, TR_PARAM_REL = 1e-3, 1e-3
TR_REPS = 20
# Kernels 3 and 7 at their timed shapes (phase 5; tools/kernel_times.py):
# relay_mix at the kernel benchmark's n=16, d=2^20 f32, block_relay_mix on
# the clustered cifar_cnn_full stack (C=2 x m=5, d=D_FULL); the timed calls
# of kernels 3 and 7 and of kernel 11
MIX_N, MIX_D = 16, 2**20
MIX_REPS, SSD_REPS = 100, 20
# Phase 13: the dry run's CLI on DR_ARCH x DR_SHAPES (host only, fake
# tensors; train_4k's 16-client trace takes minutes and is left out); then
# DR_ARCH at full width cut to EST_DEPTH layers, each step kind traced on
# fake tensors and run on the card: the train kind at the launcher's 8
# clients, T = DRYRUN_LOCAL_STEPS, 4 x 256 tokens a client (colrel with
# fused=False: no kernel on the path), the prefill kind at 4 x 1024 and
# one decode step against a 4 x 1024 cache.  FLOPs must be equal and the
# fake peak within EST_PEAK_REL of the card's max_memory_allocated above
# its baseline.  Then the three examples at small settings, on the card.
DR_ARCH, DR_SHAPES = "qwen3-0.6b", ("prefill_32k", "decode_32k")
EST_DEPTH, EST_CLIENTS = 2, 8
EST_PEAK_REL = 0.10
# (script, flags, a line its run must print)
EXAMPLES = (("quickstart_torch.py", ["--rounds", "2", "--local-steps", "2"], "ColRel final loss"),
            ("train_colrel_cifar_torch.py", ["--rounds", "2", "--out",
                                             "build/examples_torch/colrel_cifar"], "final: "),
            ("serve_decode_torch.py", ["--batch", "2", "--gen", "8"], "decode: "))


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


def bound_ms(n_bytes, flops, flops_per_s=F32_FLOPS):
    return max(n_bytes / HBM_BYTES_PER_S, flops / flops_per_s) * 1e3


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def run_counted(wrappers, label, fn, expect):
    """``fn()`` with every launch count set to 0 just before and read just
    after; ``expect`` names the kernels it must have launched.  Returns
    ``(fn(), seconds, launches)``."""
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(launched == expect, f"{label}: launches {launched}, expected {expect}")
    return out, secs, launched


@contextlib.contextmanager
def moe_drops():
    """The number of assignments each ``apply_moe`` call drops, from the
    call's own routing (``moe.route`` on the same input), in call order."""
    from repro_torch.models import moe

    real, counts = moe.apply_moe, []

    def counting(cfg, params, x):
        counts.append(int((~moe.route(cfg, params, x.reshape(-1, x.shape[-1])).keep).sum()))
        return real(cfg, params, x)

    moe.apply_moe = counting
    try:
        yield counts
    finally:
        moe.apply_moe = real


def mix_bytes(C, m, d, masks):
    """Bytes an f32 relay mix of C clusters of m rows must move: ``masks``
    (C, m, m) f32 arrays (1: the mask given, 2: A and tau), x read once and
    the output written once."""
    return 4 * masks * C * m * m + 8 * C * m * d


def ssd_bytes(BH, T, Dk, Dv):
    """Bytes bf16 kernel 11 must move: q, k, v read once, y written once,
    and the f32 log decays."""
    return 2 * (2 * BH * T * Dk + 2 * BH * T * Dv) + 4 * BH * T


def ssd_rel_l2(got, want, chunk):
    """Worst relative L2 of (BH, T, Dv) outputs over their (slice, chunk)
    blocks, and over their slices."""
    BH_, T_, _ = want.shape
    pad = -T_ % chunk
    sq = [torch.nn.functional.pad(x_.float().pow(2).sum(-1), (0, pad)).reshape(
        BH_, -1, chunk).sum(-1) for x_ in (got.float() - want.float(), want)]
    return (float((sq[0] / sq[1]).sqrt().max()),
            float((sq[0].sum(1) / sq[1].sum(1)).sqrt().max()))


def ssd_held(got, want, chunk, what):
    """Holds bf16 kernel 11's (BH, T, Dv) output to SSD_CHUNK_TOL and
    SSD_SLICE_TOL; returns the readings as text."""
    r_chunk, r_slice = ssd_rel_l2(got, want, chunk)
    check(r_chunk <= SSD_CHUNK_TOL, f"ssd_scan {what}: a chunk is {r_chunk} from its plain "
          f"version (relative L2), past {SSD_CHUNK_TOL}")
    check(r_slice <= SSD_SLICE_TOL, f"ssd_scan {what}: a slice is {r_slice} from its plain "
          f"version (relative L2), past {SSD_SLICE_TOL}")
    return (f"worst chunk relative L2 {r_chunk:.3e} (tol {SSD_CHUNK_TOL:.3e}), worst slice "
            f"{r_slice:.3e} (tol {SSD_SLICE_TOL:.3e})")


def mamba_views(gen, dev, B, H, T, Dk, Dv):
    """Kernel 11's operands as the Mamba mixer passes them: q and k one
    (B, T, 2*Dk) tensor broadcast over the H heads, v (and y) in (B, T, H, Dv)
    storage, the log decays in (B, T, H); bf16, each (B, H, T, .)."""
    kq = torch.randn(B, T, 2 * Dk, generator=gen, device=dev, dtype=torch.bfloat16)
    k, q = (x_[:, None].expand(B, H, T, Dk) for x_ in kq.split(Dk, dim=-1))
    v = torch.randn(B, T, H, Dv, generator=gen, device=dev,
                    dtype=torch.bfloat16).permute(0, 2, 1, 3)
    logd = (-torch.rand(B, T, H, generator=gen, device=dev)).permute(0, 2, 1)
    return q, k, v, logd


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
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import fused_aggregate as fa
    from repro_torch.kernels import fused_dequant as fdq
    from repro_torch.kernels import fused_memory as fm
    from repro_torch.kernels import ops
    from repro_torch.kernels import relay_block as rb
    from repro_torch.kernels import relay_mix as rm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.cnn import CNN

    dev = torch.device("cuda")
    t_main = time.perf_counter()
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
    # ptxas's report per kernel: registers, spills, static shared memory;
    # the bf16 flash kernel's dynamic shared memory from the library
    kernel_name = ""
    for line in pathlib.Path(lib._name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel_name = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            print(f"[build] {kernel_name}: {line.strip()}")
    print("[build] flash_tc_kernel dynamic shared memory per block: " + ", ".join(
        f"D={d_} {lib.repro_flash_tc_smem_bytes(d_)} bytes" for d_ in fl.HEAD_DIMS))
    print(f"[build] resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
          f"ssd_scan_tc_kernel at chunk 64, Dk 16, Dv 64: {lib.repro_ssd_scan_blocks_per_sm(64, 16, 64)}"
          f" (Dk 32: {lib.repro_ssd_scan_blocks_per_sm(64, 32, 64)}); relay_mix_kernel f32 "
          f"16-byte path at m=16: {lib.repro_relay_mix_blocks_per_sm(16, 0, 1)} (m=110: "
          f"{lib.repro_relay_mix_blocks_per_sm(110, 0, 1)}), scalar path at "
          f"m=5: {lib.repro_relay_mix_blocks_per_sm(5, 0, 0)}, bf16 16-byte path at m=16: "
          f"{lib.repro_relay_mix_blocks_per_sm(16, 1, 1)}")

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

    def exact_row(name, got, want, what):
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} {what}: shape/dtype")
        e = float((got - want).abs().max())
        check(torch.equal(got, want), f"{name} {what}: differs by {e}")
        max_err[name] = max(max_err[name], e)
        return e

    max_err = dict.fromkeys(("fused_aggregate", "row_stream", "fused_memory_update",
                             "memory_stream", "fused_dequant_aggregate", "relay_mix",
                             "block_relay_mix", "block_fused_aggregate", "block_row_stream",
                             "flash_attention", "ssd_scan"),
                            0.0)
    # kernels 1 and 6 bitwise: n = 1 to 33 at the main path's and off-grid d,
    # and n = 4096 (the wrappers' largest, 256 batches of the collapse's
    # loads) at d = 4099
    collapse_cases = [(n_, d_) for n_ in (1, 4, 10, 33) for d_ in (1, 1000, 4099, d_full)]
    collapse_cases.append((4096, 4099))
    for dtype in (torch.float32, torch.bfloat16):
        for n_, d_ in collapse_cases:
            A, tau_up, tau_dd, X = inputs(n_, d_, dtype)
            e = exact_row("fused_aggregate", fa.fused_aggregate_cuda(A, tau_up, tau_dd, X),
                          fa.fused_aggregate_plain(A, tau_up, tau_dd, X),
                          f"{str(dtype)[6:]} n={n_} d={d_}")
            print(f"[kernels] fused_aggregate {str(dtype)[6:]} n={n_} d={d_} max_abs_err={e:.3e} "
                  f"(bitwise)")
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
    # the grouped launch over the 61 segments, bitwise: against its plain
    # version, the per-segment kernel and the monolithic kernel (1, or 6 for
    # int8)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        A, tau_up, tau_dd, X = inputs(n, d_full, dtype)
        w = ops.collapsed_weight_row(A, tau_up, tau_dd)
        if dtype == torch.int8:
            scale = torch.full((n, 1), 1 / 40, device=dev)
            w = ops.fold_dequant_scales(w, scale)
            mono = fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, X, scale)
        else:
            mono = fa.fused_aggregate_cuda(A, tau_up, tau_dd, X)
        segs = [s.contiguous() for s in X.split(full_sizes, dim=1)]
        got = fa.row_stream_segments_cuda(w, segs)
        e = exact_row("row_stream", got, fa.row_stream_segments_plain(w, segs),
                      f"grouped {str(dtype)[6:]} vs its plain version")
        check(torch.equal(got, torch.cat([fa.row_stream_cuda(w, s) for s in segs])),
              f"row_stream grouped {dtype} vs the per-segment kernel")
        check(torch.equal(got, mono), f"row_stream grouped {dtype} vs the monolithic kernel")
        print(f"[kernels] row_stream_segments {str(dtype)[6:]}, one launch over the 61 segments: "
              f"max_abs_err={e:.3e} vs plain; == the per-segment kernel and the monolithic "
              f"kernel, bitwise")

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
        # the grouped launch over the same 61 segments into the whole buffer
        grouped_buf, plain_buf = B.clone(), B.clone()
        segs = [s_.contiguous() for s_ in X.split(full_sizes, dim=1)]
        got, out = fm.memory_stream_segments_cuda(mix, tau_up, segs, grouped_buf)
        check(out is grouped_buf, "memory_stream_segments returned another buffer")
        want, _ = fm.memory_stream_segments_plain(mix, tau_up, segs, plain_buf)
        e = max(exact_row("memory_stream", got, want, f"grouped {str(dtype)[6:]} delta"),
                exact_row("memory_stream", grouped_buf, plain_buf, f"grouped {str(dtype)[6:]} buffer"))
        check(torch.equal(got, torch.cat(deltas)) and torch.equal(grouped_buf, buf),
              f"memory grouped {dtype} vs the per-segment kernel")
        check(torch.equal(got, mono) and torch.equal(grouped_buf, mono_buf),
              f"memory grouped {dtype} vs the monolithic kernel")
        print(f"[kernels] memory_stream_segments {str(dtype)[6:]}, one launch over the 61 "
              f"segments: max_abs_err={e:.3e} vs plain (delta and buffer); == the per-segment "
              f"kernel and the monolithic kernel, bitwise")
    for n_, d_ in collapse_cases:
        A, tau_up, tau_dd, q = inputs(n_, d_, torch.int8)
        scale = torch.rand(n_, 1, generator=g).to(dev) / 40
        e = exact_row("fused_dequant_aggregate",
                      fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, q, scale),
                      fdq.fused_dequant_aggregate_plain(A, tau_up, tau_dd, q, scale),
                      f"int8 n={n_} d={d_}")
        print(f"[kernels] fused_dequant_aggregate int8 n={n_} d={d_} max_abs_err={e:.3e} "
              f"(bitwise)")

    # the clustered kernels and the dense relay mix, held bitwise (tolerance
    # 0): they run their plain versions' arithmetic in the same order
    def block_inputs(C, m, d_, dtype):
        Ab = (torch.rand(C, m, m, generator=g) * 0.5 + 0.1).to(dev)
        tau_up = (torch.rand(C * m, generator=g) < 0.7).float().to(dev)
        tau_b = (torch.rand(C, m, m, generator=g) < 0.5).float().to(dev)
        return Ab, tau_up, tau_b, torch.randn(C * m, d_, generator=g).to(dtype).to(dev)

    def exact(name, got, want, what):
        check(got.shape == want.shape and got.dtype == want.dtype, f"{name} {what}: shape/dtype")
        e = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"{name} {what}: differs from its plain version by {e}")
        max_err[name] = max(max_err[name], e)
        return e

    def block_kernels(C, m, d_, dtype):
        Ab, tau_up, tau_b, X = block_inputs(C, m, d_, dtype)
        what = f"{str(dtype)[6:]} C={C} m={m} n={C * m} d={d_}"
        e = exact("block_relay_mix", rb.block_relay_mix_cuda(Ab, tau_b, X),
                  rb.block_relay_mix_plain(Ab, tau_b, X), what)
        agg = rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)
        e = max(e, exact("block_fused_aggregate", agg,
                         rb.block_fused_aggregate_plain(Ab, tau_up, tau_b, X), what))
        w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
        seg = rb.block_row_stream_cuda(w, X)
        e = max(e, exact("block_row_stream", seg, rb.block_row_stream_plain(w, X), what))
        check(torch.equal(seg, agg), f"block_row_stream vs block_fused_aggregate {what}")
        print(f"[kernels] block_relay_mix, block_fused_aggregate, block_row_stream {what} "
              f"max_abs_err={e:.3e}")

    for dtype in (torch.float32, torch.bfloat16):
        for C, m in ((1, 4), (1, 10), (2, 5), (1, 33), (3, 11), (64, 16)):
            for d_ in (1, 1000, 4099, d_full):
                block_kernels(C, m, d_, dtype)
        block_kernels(256, 64, 4099, dtype)  # n = 16,384: the reference's largest population
    for dtype in (torch.float32, torch.bfloat16):
        for n_ in (4, 10, 16, 33):
            for d_ in (1, 1000, 4099, d_full):
                M = torch.randn(n_, n_, generator=g).to(dev)
                X = torch.randn(n_, d_, generator=g).to(dtype).to(dev)
                e = exact("relay_mix", rm.relay_mix_cuda(M, X), rm.relay_mix_plain(M, X),
                          f"{str(dtype)[6:]} n={n_} d={d_}")
                print(f"[kernels] relay_mix {str(dtype)[6:]} n={n_} d={d_} max_abs_err={e:.3e}")
        M = torch.randn(16, 16, generator=g).to(dev)
        X = torch.randn(16, 2**20, generator=g).to(dtype).to(dev)
        e = exact("relay_mix", rm.relay_mix_cuda(M, X), rm.relay_mix_plain(M, X),
                  f"{str(dtype)[6:]} n=16 d=2^20")
        print(f"[kernels] relay_mix {str(dtype)[6:]} n=16 d=2^20 (the kernel benchmark's shape) "
              f"max_abs_err={e:.3e}")
    # one cluster is the dense population: kernels 8, 9, 7 equal kernels 1, 2, 3
    for dtype in (torch.float32, torch.bfloat16):
        for n_ in (4, 10, 33):
            for d_ in (1, 1000, 4099, d_full):
                A, tau_up, tau_dd, X = inputs(n_, d_, dtype)
                w = ops.collapsed_weight_row(A, tau_up, tau_dd)
                mix = ops.mixing_mask(A, tau_dd)
                for name, got, want in (
                        ("block_fused_aggregate vs fused_aggregate",
                         rb.block_fused_aggregate_cuda(A[None], tau_up, tau_dd[None], X),
                         fa.fused_aggregate_cuda(A, tau_up, tau_dd, X)),
                        ("block_row_stream vs row_stream",
                         rb.block_row_stream_cuda(w.reshape(1, n_), X), fa.row_stream_cuda(w, X)),
                        ("block_relay_mix vs relay_mix",
                         rb.block_relay_mix_cuda(A[None], tau_dd[None], X),
                         rm.relay_mix_cuda(mix, X))):
                    check(torch.equal(got, want), f"C=1 {name} {str(dtype)[6:]} n={n_} d={d_}")
    print("[kernels] C=1: block_fused_aggregate == fused_aggregate, block_row_stream == "
          "row_stream, block_relay_mix == relay_mix, bitwise, at n in (4, 10, 33), "
          f"d in (1, 1000, 4099, {d_full}), f32 and bf16")
    # the 61 cifar_cnn_full segments through block_row_stream against the
    # monolithic block_fused_aggregate, n=10 as 2 clusters of 5
    for dtype in (torch.float32, torch.bfloat16):
        Ab, tau_up, tau_b, X = block_inputs(2, 5, d_full, dtype)
        w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
        segs = torch.cat([rb.block_row_stream_cuda(w, s_.contiguous())
                          for s_ in X.split(full_sizes, dim=1)])
        check(torch.equal(segs, rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)),
              f"block segments vs monolithic {dtype}")
        print(f"[kernels] block_row_stream {str(dtype)[6:]} over the 61 segments == "
              f"block_fused_aggregate at n=10 (C=2, m=5) d={d_full}: bitwise")
    # the grouped launch of kernel 9 over the 61 segments, bitwise: against
    # its plain version, the per-segment kernel 9 and kernel 8; at C = 1
    # against the grouped kernel 2; and at n = 16,384 (256 clusters of 64)
    for dtype in (torch.float32, torch.bfloat16):
        Ab, tau_up, tau_b, X = block_inputs(2, 5, d_full, dtype)
        w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
        segs = [s_.contiguous() for s_ in X.split(full_sizes, dim=1)]
        got = rb.block_row_stream_segments_cuda(w, segs)
        e = exact("block_row_stream", got, rb.block_row_stream_segments_plain(w, segs),
                  f"grouped {str(dtype)[6:]}")
        check(torch.equal(got, torch.cat([rb.block_row_stream_cuda(w, s_) for s_ in segs])),
              f"block_row_stream grouped {dtype} vs the per-segment kernel")
        check(torch.equal(got, rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)),
              f"block_row_stream grouped {dtype} vs block_fused_aggregate")
        A, tau_up, tau_dd, X = inputs(n, d_full, dtype)
        w = ops.collapsed_weight_row(A, tau_up, tau_dd)
        segs = [s_.contiguous() for s_ in X.split(full_sizes, dim=1)]
        check(torch.equal(rb.block_row_stream_segments_cuda(w.reshape(1, n), segs),
                          fa.row_stream_segments_cuda(w, segs)),
              f"block_row_stream grouped at C=1 vs row_stream grouped {dtype}")
        Ab, tau_up, tau_b, X = block_inputs(256, 64, 1 + 10 + 4097, dtype)
        w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
        segs = [s_.contiguous() for s_ in X.split([1, 10, 4097], dim=1)]
        got = rb.block_row_stream_segments_cuda(w, segs)
        e = max(e, exact("block_row_stream", got, rb.block_row_stream_segments_plain(w, segs),
                         f"grouped {str(dtype)[6:]} n=16384"))
        check(torch.equal(got, rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)),
              f"block_row_stream grouped {dtype} n=16384 vs block_fused_aggregate")
        print(f"[kernels] block_row_stream_segments {str(dtype)[6:]}, one launch over the 61 "
              f"segments (C=2, m=5): max_abs_err={e:.3e} vs plain; == the per-segment kernel and "
              f"block_fused_aggregate; at C=1 == row_stream_segments; at n=16384 (C=256, m=64) "
              f"over widths 1, 10, 4097 == plain and block_fused_aggregate; all bitwise")

    # kernel 10, causal flash attention, against its plain version; T=192
    # is a ragged tail at the kernel's 128-row query tiles
    def flash_check(got, want, launched, what):
        tol = FLASH_TOL[want.dtype]
        check(launched == 1, f"flash_attention {what}: launches moved by {launched}, not 1")
        check(got.shape == want.shape and got.dtype == want.dtype, f"flash_attention {what}: "
              f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        e = (got.float() - want.float()).abs()
        check(bool(torch.all(e <= tol + tol * want.float().abs())),
              f"flash_attention {what}: disagrees with its plain version by {float(e.max())}")
        max_err["flash_attention"] = max(max_err["flash_attention"], float(e.max()))
        # bf16: each (head, 128-row block) held by relative L2, a limit that
        # scales with the output (late rows of a causal pass are small)
        blk = ""
        if want.dtype == torch.bfloat16:
            pad = -got.shape[1] % 128
            sq = [torch.nn.functional.pad(x_.float().pow(2).sum(-1), (0, pad)).reshape(
                got.shape[0], -1, 128).sum(-1) for x_ in (got.float() - want.float(), want)]
            r = float((sq[0] / sq[1]).sqrt().max())
            check(r <= FLASH_BLOCK_TOL, f"flash_attention {what}: a 128-row block is {r} "
                  f"from its plain version (relative L2), past {FLASH_BLOCK_TOL}")
            blk = f", worst 128-row block relative L2 {r:.3e} (tol {FLASH_BLOCK_TOL:.3e})"
        print(f"[kernels] flash_attention {what} max_abs_err={float(e.max()):.3e} "
              f"(atol = rtol = {tol}){blk}, launches +{launched}")

    def heads_first(x):
        B_, T_, H_, D_ = x.shape
        return x.transpose(1, 2).reshape(B_ * H_, T_, D_).contiguous()

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 128, 64), (8, 256, 32), (2, 192, 128), (64, 1024, 64)):
            q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev) for _ in range(3))
            before = fl.flash_attention_cuda.launches
            got = fl.flash_attention_cuda(q, k, v)
            flash_check(got, fl.flash_attention_plain(q, k, v),
                        fl.flash_attention_cuda.launches - before,
                        f"{str(dtype)[6:]} (BH, T, D)={shape}")
        # the GQA entry point: 16 query heads over 8 kv heads, (B, T, H, D)
        q = torch.randn(2, 256, 16, 64, generator=g).to(dtype).to(dev)
        k, v = (torch.randn(2, 256, 8, 64, generator=g).to(dtype).to(dev) for _ in range(2))
        before = fl.flash_attention_cuda.launches
        got = ops.flash_attention(q, k, v)
        launched = fl.flash_attention_cuda.launches - before
        want = fl.flash_attention_plain(heads_first(q), heads_first(k.repeat_interleave(2, 2)),
                                        heads_first(v.repeat_interleave(2, 2)))
        flash_check(heads_first(got), want, launched,
                    f"{str(dtype)[6:]} ops.flash_attention GQA B=2 T=256 H=16 KV=8 D=64")
    del q, k, v, got, want

    # kernel 11, the chunked SSD recurrence, against its plain version: the
    # reference test's shapes and chunks, and the jamba prefill's own shape
    def ssd_check(shape, chunk, dtype, gen=g, decay=1.0):
        BH_, T_, Dk_, Dv_ = shape
        q_, k_ = (torch.randn(BH_, T_, Dk_, generator=gen).to(dtype).to(dev) for _ in range(2))
        v_ = torch.randn(BH_, T_, Dv_, generator=gen).to(dtype).to(dev)
        ld_ = (-torch.rand(BH_, T_, generator=gen) * decay).to(dev)
        before = ssd.ssd_scan_cuda.launches
        got_ = ssd.ssd_scan_cuda(q_, k_, v_, ld_, chunk=chunk)
        launched = ssd.ssd_scan_cuda.launches - before
        want_ = ssd.ssd_scan_plain(q_, k_, v_, ld_, chunk=chunk)
        what = f"{str(dtype)[6:]} (BH, T, Dk, Dv)={shape} chunk={chunk} decays x{decay}"
        tol = SSD_TOL[dtype]
        check(launched == 1, f"ssd_scan {what}: launches moved by {launched}, not 1")
        check(got_.shape == want_.shape and got_.dtype == want_.dtype, f"ssd_scan {what}: "
              f"{tuple(got_.shape)} {got_.dtype} vs {tuple(want_.shape)} {want_.dtype}")
        e = (got_.float() - want_.float()).abs()
        check(bool(torch.all(e <= tol + tol * want_.float().abs())),
              f"ssd_scan {what}: disagrees with its plain version by {float(e.max())}")
        max_err["ssd_scan"] = max(max_err["ssd_scan"], float(e.max()))
        blk = ", " + ssd_held(got_, want_, chunk, what) if dtype == torch.bfloat16 else ""
        print(f"[kernels] ssd_scan {what} max_abs_err={float(e.max()):.3e} "
              f"(atol = rtol = {tol}){blk}, launches +{launched}")

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 128, 8, 16), (1, 64, 4, 4), (3, 96, 16, 32)):
            for chunk in (16, 32):
                ssd_check(shape, chunk, dtype)
        ssd_check(SSD_PREFILL_SHAPE, 64, dtype)
    # slow decays: a state that lives across chunks, where the state's
    # split products (S, k * decay) weigh in the output
    ssd_check(SSD_PREFILL_SHAPE, 64, torch.bfloat16, torch.Generator().manual_seed(1), 1 / 16)
    torch.cuda.synchronize()

    # -- 4. the main path at full width ------------------------------------
    # one aggregation of cifar_cnn_full-shaped client deltas through every path
    import numpy as np

    from repro_torch import strategies
    from repro_torch.channel import (
        ClusteredMarkovChannel,
        ClusteredStaticChannel,
        StaticChannel,
        gilbert_elliott_clustered,
    )
    from repro_torch.core import blocks as core_blocks
    from repro_torch.core import topology
    from repro_torch.core.weights import optimize_weights, optimize_weights_clustered
    from repro_torch.data.pipeline import ClientDataset
    from repro_torch.fl.experiment import Experiment, build_task
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.optim import sgd, sgd_momentum
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
    # codec seed (the kernel path and the dequant oracle draw the same q)
    buf0 = 1e-2 * torch.randn(n, d_full, generator=g).to(dev)
    seg_ctx = ExecutionContext(n_clients=n, segment_d=1)
    mem = {label: strategies.get("memory", fused=fused).aggregate_tree(
        deltas, tu, td, A, buf0.clone(), c)
        for label, fused, c in (("kernel", "kernel", ctx), ("segmented", "kernel", seg_ctx),
                                ("fused=False", False, ctx))}
    quant = {}
    for label, fused in (("kernel", "kernel"), ("fused=False", False)):
        qs = strategies.get("quantized", codec="int8", fused=fused)
        quant[label] = qs.aggregate_tree(deltas, tu, td, A, qs.init_state(n, d_full, device=dev),
                                         ctx)[0]
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
    # clustered relaying of the same deltas: n=10 as 2 clusters of 5, the
    # topology arguments of the reference's shard benchmark, per-cluster
    # COPT-alpha weights
    cmodel = topology.clustered_blocks(n, 0.5, 5, p_intra=0.8, rho=1.0)
    cAb_np = optimize_weights_clustered(cmodel, sweeps=30, fine_tune_sweeps=30).Ab
    cAb = torch.as_tensor(cAb_np, dtype=torch.float32, device=dev)
    ctu, ctb = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                for t in ClusteredStaticChannel(cmodel, seed=0).tau_for_round(0))
    cagg = {label: tree.leaves(strategies.get("clustered", fused=fused).aggregate_tree(
        deltas, ctu, ctb, cAb, (), c)[0])
        for label, fused, c in (("kernel", "kernel", ctx), ("segmented", "kernel", seg_ctx),
                                ("collapse", "collapse", ctx), ("faithful", False, ctx))}
    for label, atol in (("segmented", 0.0), ("collapse", AGG_ATOL), ("faithful", AGG_ATOL)):
        diff = max(float((a - b).abs().max()) for a, b in zip(cagg["kernel"], cagg[label]))
        check(diff <= atol, f"one clustered aggregation, kernel vs {label}: {diff}")
        print(f"[main] one clustered aggregation of cifar_cnn_full deltas (C=2, m=5), kernel vs "
              f"{label}: max_abs_diff={diff:.3e} (atol {atol})")

    # kernels 3 and 7 are reached through their entry points ops.relay_mix
    # and ops.block_relay_mix: each driven once, its count set to 0 just
    # before and read just after
    stack = flatten.ravel_stacked(deltas)
    M16 = torch.randn(MIX_N, MIX_N, generator=g).to(dev)
    X16 = torch.randn(MIX_N, MIX_D, generator=g).to(dev)
    rm.relay_mix_cuda.launches = rb.block_relay_mix_cuda.launches = 0
    mixed16 = ops.relay_mix(M16, X16)
    cmixed = ops.block_relay_mix(cAb, ctb, stack)
    mix_launches = {"relay_mix": rm.relay_mix_cuda.launches,
                    "block_relay_mix": rb.block_relay_mix_cuda.launches}
    check(mix_launches == {"relay_mix": 1, "block_relay_mix": 1},
          f"relay-mix entry points launched {mix_launches}")
    check(torch.equal(mixed16, rm.relay_mix_plain(M16, X16)), "ops.relay_mix vs its plain version")
    diff = float((cmixed - core_blocks.block_relay_mix(stack, cAb, ctb)).abs().max())
    check(diff <= AGG_ATOL and cmixed.shape == stack.shape,
          f"ops.block_relay_mix vs core.blocks.block_relay_mix: {diff}")
    print(f"[main] ops.relay_mix at n=16 d=2^20 and ops.block_relay_mix on the cifar_cnn_full "
          f"stack (C=2, m=5): launches {mix_launches}; block relay mix vs core.blocks "
          f"max_abs_diff={diff:.3e} (atol {AGG_ATOL})")
    del deltas, agg, mem, quant, buf0, cagg, stack, cmixed, mixed16

    wrappers = {"fused_aggregate": fa.fused_aggregate_cuda, "row_stream": fa.row_stream_cuda,
                "row_stream_segments": fa.row_stream_segments_cuda,
                "fused_memory_update": fm.fused_memory_update_cuda,
                "memory_stream": fm.memory_stream_cuda,
                "memory_stream_segments": fm.memory_stream_segments_cuda,
                "fused_dequant_aggregate": fdq.fused_dequant_aggregate_cuda,
                "relay_mix": rm.relay_mix_cuda, "block_relay_mix": rb.block_relay_mix_cuda,
                "block_fused_aggregate": rb.block_fused_aggregate_cuda,
                "block_row_stream": rb.block_row_stream_cuda,
                "block_row_stream_segments": rb.block_row_stream_segments_cuda,
                "flash_attention": fl.flash_attention_cuda, "ssd_scan": ssd.ssd_scan_cuda}

    def drive(label, strategy, options, segment_d, *, channel="static", expect, make=None,
              layout=(N_LEAVES, D_FULL), rounds=ROUNDS):
        """``rounds`` rounds of one path with every launch count set to 0 just
        before and read just after; ``expect`` names the kernels the path
        must have launched and how often, every other count must be 0.
        The path is a cifar_cnn_full experiment, or the experiment ``make``
        builds; its params must be ``layout`` (leaves, d) finite CUDA
        tensors."""
        for w in wrappers.values():
            w.launches = 0
        exp = make() if make is not None else build_experiment(ExperimentSpec(
            model="cifar_cnn_full", strategy=strategy, strategy_options=options,
            segment_d=segment_d, channel=channel))
        secs = []
        for _ in range(rounds):
            t = time.perf_counter()
            exp.run(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        counts = {k: w.launches for k, w in wrappers.items()}
        round_s[label] = secs
        loss = exp.log.loss
        check(all(math.isfinite(v) for v in loss), f"{label}: non-finite loss {loss}")
        leaves = tree.leaves(exp.params)
        check(len(leaves) == layout[0] and sum(x.numel() for x in leaves) == layout[1]
              and all(bool(torch.isfinite(x).all()) and x.is_cuda for x in leaves),
              f"{label}: params are not {layout[0]} finite CUDA leaves of d={layout[1]}")
        launched = {k: v for k, v in counts.items() if v}
        print(f"[main] {label}: {strategy} {options} segment_d={segment_d} channel={channel}: "
              f"loss={loss} participation={exp.log.participation} "
              f"uplink_bits={exp.log.uplink_bits} weight_sum={exp.log.weight_sums} "
              f"launches={launched} s/round={[round(x, 4) for x in secs]} [{card}]")
        check(launched == expect, f"{label}: launches {launched}, expected {expect}")
        return exp, counts

    def max_diff(xs, ys):
        return max(float((a - b).abs().max()) for a, b in zip(xs, ys))

    def compare(label, ref, others, rounds=ROUNDS):
        """Params (and the replay buffer, where the strategy carries one) of
        ``ref`` against each other run."""
        for name, other, atol in others:
            diffs = {"params": max_diff(tree.leaves(ref.params), tree.leaves(other.params))}
            if isinstance(ref.trainer.agg_state, torch.Tensor):
                diffs["replay buffer"] = max_diff([ref.trainer.agg_state],
                                                  [other.trainer.agg_state])
            for what, diff in diffs.items():
                check(diff <= atol, f"{label} vs {name}: {what} differ by {diff}")
                print(f"[main] {label} vs {name} after {rounds} rounds: {what} "
                      f"max_abs_diff={diff:.3e} (atol {atol})")
            check(ref.log.participation == other.log.participation,
                  f"{label} vs {name}: participation differs")

    round_s = {}
    kernel_exp, counts = drive("colrel kernel", "colrel", {"fused": "kernel"}, 0,
                               expect={"fused_aggregate": ROUNDS})
    fa_launches = counts["fused_aggregate"]
    seg_exp, counts = drive("colrel segmented", "colrel", {"fused": "kernel"}, 1,
                            expect={"row_stream_segments": ROUNDS})
    rs_launches = counts["row_stream_segments"]
    col_exp, _ = drive("colrel collapse", "colrel", {"fused": "collapse"}, 0, expect={})
    compare("colrel kernel", kernel_exp, (("segmented", seg_exp, PARAM_ATOL),
                                          ("collapse", col_exp, PARAM_ATOL)))

    # the memory strategy under bursty blockage: kernel, segments, plain path
    mem_exp, counts = drive("memory kernel", "memory", {"fused": "kernel"}, 0, channel="markov",
                            expect={"fused_memory_update": ROUNDS})
    fmu_launches = counts["fused_memory_update"]
    mem_seg, counts = drive("memory segmented", "memory", {"fused": "kernel"}, 1,
                            channel="markov", expect={"memory_stream_segments": ROUNDS})
    ms_launches = counts["memory_stream_segments"]
    mem_plain, _ = drive("memory plain", "memory", {"fused": False}, 0, channel="markov",
                         expect={})
    compare("memory kernel", mem_exp, (("segmented", mem_seg, 0.0),
                                       ("fused=False", mem_plain, STRATEGY_PARAM_ATOL)))
    check(min(mem_exp.log.participation) < n,
          f"memory: every uplink arrived in every round {mem_exp.log.participation}; "
          "the replay branch never ran")

    # int8 quantized relaying: fused dequant kernel, the int8 segments
    # through one grouped row_stream launch a round, and the dequant oracle,
    # which draws the kernel path's codec stream
    q_opts = {"codec": "int8", "fused": "kernel"}
    q_exp, counts = drive("quantized kernel", "quantized", q_opts, 0,
                          expect={"fused_dequant_aggregate": ROUNDS})
    fdq_launches = counts["fused_dequant_aggregate"]
    q_seg, counts = drive("quantized segmented", "quantized", q_opts, 1,
                          expect={"row_stream_segments": ROUNDS})
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

    # clustered relaying at full width: an FLTrainer given the clustered
    # channel and the (C, m, m) weights, as the reference's shard benchmark
    # enters the path
    def clustered_exp(fused, segment_d, channel):
        spec = ExperimentSpec(model="cifar_cnn_full")
        loss_fn, init, clients, client_opt, server_opt, steps, _ = build_task(spec, n)
        strategy = strategies.get("clustered", fused=fused)
        trainer = FLTrainer(loss_fn, init, None, cAb_np, clients, client_opt, server_opt,
                            local_steps=steps, strategy=strategy, channel=channel,
                            segment_d=segment_d)
        return Experiment(spec=spec, trainer=trainer, link_model=cmodel, A=cAb_np,
                          strategy=strategy)

    cl_runs = {}
    for label, fused, segment_d, expect in (
            ("kernel", "kernel", 0, {"block_fused_aggregate": ROUNDS}),
            ("segmented", "kernel", 1, {"block_row_stream_segments": ROUNDS}),
            ("collapse", "collapse", 0, {}), ("plain", False, 0, {})):
        cl_runs[label] = drive(
            f"clustered {label}", "clustered", {"fused": fused}, segment_d,
            channel="ClusteredStaticChannel", expect=expect,
            make=lambda f=fused, sd=segment_d: clustered_exp(
                f, sd, ClusteredStaticChannel(cmodel, seed=0)))
    bfa_launches = cl_runs["kernel"][1]["block_fused_aggregate"]
    brs_launches = cl_runs["segmented"][1]["block_row_stream_segments"]
    compare("clustered kernel", cl_runs["kernel"][0],
            (("segmented", cl_runs["segmented"][0], 0.0),
             ("collapse", cl_runs["collapse"][0], PARAM_ATOL),
             ("fused=False", cl_runs["plain"][0], PARAM_ATOL)))
    cl_markov, _ = drive(
        "clustered kernel markov", "clustered", {"fused": "kernel"}, 0,
        channel="ClusteredMarkovChannel(memory=0.9)", expect={"block_fused_aggregate": ROUNDS},
        make=lambda: clustered_exp("kernel", 0, ClusteredMarkovChannel(
            gilbert_elliott_clustered(cmodel, memory=0.9), seed=0)))

    # the population path, the reference shard benchmark's gate point:
    # n=1024 as 64 clusters of 16, the D=64 quadratic, one local SGD step
    P_N, P_M, P_D = 1024, 16, 64
    pmodel = topology.clustered_blocks(P_N, 0.5, P_M, p_intra=0.8, rho=1.0)
    # every cluster of clustered_blocks is identical: one per-cluster
    # COPT-alpha solve serves all 64 blocks
    pres = optimize_weights(pmodel.cluster_model(0), sweeps=10, fine_tune_sweeps=5)
    pAb = np.broadcast_to(pres.A.astype(np.float32), (pmodel.C, P_M, P_M)).copy()
    H = torch.as_tensor(np.diag(np.linspace(1.0, 8.0, P_D)).astype(np.float32), device=dev)

    def quad_loss(params, batch):
        r = params["x"] - batch["t"][0]
        return 0.5 * r @ (H @ r), {}

    def population_exp(fused, **trainer_kw):
        rng = np.random.default_rng(7)
        clients = [ClientDataset({"t": rng.normal(size=(ROUNDS, P_D)).astype(np.float32)},
                                 batch_size=1, seed=i) for i in range(P_N)]
        strategy = strategies.get("clustered", fused=fused)
        trainer = FLTrainer(quad_loss, {"x": torch.zeros(P_D, device=dev)}, None, pAb, clients,
                            sgd(0.1), sgd_momentum(1.0, beta=0.9), local_steps=1,
                            strategy=strategy,
                            channel=ClusteredStaticChannel(pmodel, seed=0, block=ROUNDS),
                            **trainer_kw)
        return Experiment(spec=ExperimentSpec(model="quadratic"), trainer=trainer,
                          link_model=pmodel, A=pAb, strategy=strategy)

    pop_k, _ = drive("population kernel", "clustered", {"fused": "kernel"}, 0,
                     channel="ClusteredStaticChannel n=1024 C=64 m=16",
                     expect={"block_fused_aggregate": ROUNDS},
                     make=lambda: population_exp("kernel"), layout=(1, P_D))
    pop_p, _ = drive("population plain", "clustered", {"fused": False}, 0,
                     channel="ClusteredStaticChannel n=1024 C=64 m=16", expect={},
                     make=lambda: population_exp(False), layout=(1, P_D))
    compare("population kernel", pop_k, (("fused=False", pop_p, POP_ATOL),))

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

    # -- 4b. the chunked engine ---------------------------------------------
    # every kernel path of phase 4 (and the collapse) once more from the same
    # init as one chunk of ROUNDS rounds: one round captured as a CUDA graph
    # and replayed ROUNDS times, held bitwise to the path's per-round run
    libcuda = ctypes.CDLL("libcuda.so.1")

    def graph_nodes(graph):
        count = ctypes.c_size_t(0)
        err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                      ctypes.byref(count))
        check(err == 0, f"cuGraphGetNodes returned {err}")
        return count.value

    def engine_line(scan):
        st = scan.stats
        return (f"warm-up {st['warmup_s']:.2f} s, capture {st['capture_s']:.2f} s, instantiate "
                f"{st['instantiate_s']:.2f} s, {graph_nodes(scan.graph)} graph nodes, graph pool "
                f"{st['pool_bytes'] / 1e9:.3f} GB, chunk batch and tau buffers "
                f"{st['buffer_bytes'] / 1e9:.3f} GB")

    def short(counts):
        return {k.removesuffix("_cuda"): v for k, v in counts.items()}

    def same_run(label, ref, exp, rounds=ROUNDS):
        """Two runs' round metrics (every key the round returns), params,
        server state and strategy state, bitwise."""
        rm, em = ref.trainer.round_metrics, exp.trainer.round_metrics
        check(list(rm) == list(em), f"{label}: metric keys {list(em)} against {list(rm)}")
        for k, x in rm.items():
            y = em[k]
            check(len(x) == len(y) == rounds and all(
                u == v or (math.isnan(u) and math.isnan(v)) for u, v in zip(x, y)),
                f"{label}: {k} {y} differs from {x}")
        for state in ("params", "server_state", "agg_state"):
            for a, b in zip(tree.leaves(getattr(ref.trainer, state)),
                            tree.leaves(getattr(exp.trainer, state))):
                same = (torch.equal(a.get_state(), b.get_state())
                        if isinstance(a, torch.Generator) else torch.equal(a, b))
                check(same, f"{label}: {state} differs")

    def drive_chunked(label, ref, make, expect):
        """``make()``'s path as one chunk of ROUNDS rounds, every launch count
        set to 0 just before and read just after: the counts are the eager
        warm-up round's plus the captured round's, and the captured round
        launches each kernel of ``expect`` once.  Params, server state,
        strategy state and per-round metrics equal ``ref``'s to the bit."""
        for w_ in wrappers.values():
            w_.launches = 0
        exp = make()
        torch.cuda.synchronize()
        t = time.perf_counter()
        exp.run(ROUNDS, chunk=ROUNDS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        scan = exp.trainer._scan_fn
        st = scan.stats
        check(scan.graph is not None and st["replays"] == ROUNDS,
              f"{label}: the chunk did not replay a captured round")
        counts = {k: w_.launches for k, w_ in wrappers.items() if w_.launches}
        captured, warm = short(st["captured_launches"]), short(st["warmup_launches"])
        check(captured == {k: 1 for k in expect} and warm == captured,
              f"{label}: captured launches {captured}, warm-up {warm}, expected one of {expect}")
        check(counts == {k: warm[k] + captured[k] for k in captured},
              f"{label}: counted launches {counts} are not the warm-up's and the capture's")
        same_run(f"{label}: chunked", ref, exp)
        print(f"[chunk] {label}: {ROUNDS} rounds as one chunk, bitwise equal to the per-round run "
              f"(params, server state, strategy state, every round metric: "
              f"{', '.join(exp.trainer.round_metrics)}); kernel launches a chunk "
              f"{ {k: v * ROUNDS for k, v in captured.items()} } (captured {captured} a round x "
              f"{ROUNDS} replays; the eager warm-up round {warm}); {engine_line(scan)}; "
              f"chunk {secs:.2f} s [{card}]")
        del exp, scan
        torch.cuda.empty_cache()

    def spec_path(strategy, options, segment_d, channel="static"):
        return lambda: build_experiment(ExperimentSpec(
            model="cifar_cnn_full", strategy=strategy, strategy_options=options,
            segment_d=segment_d, channel=channel))

    chunk_paths = (
        ("colrel kernel", kernel_exp, spec_path("colrel", {"fused": "kernel"}, 0),
         {"fused_aggregate"}),
        ("colrel segmented", seg_exp, spec_path("colrel", {"fused": "kernel"}, 1),
         {"row_stream_segments"}),
        ("colrel collapse", col_exp, spec_path("colrel", {"fused": "collapse"}, 0), set()),
        ("memory kernel", mem_exp, spec_path("memory", {"fused": "kernel"}, 0, "markov"),
         {"fused_memory_update"}),
        ("memory segmented", mem_seg, spec_path("memory", {"fused": "kernel"}, 1, "markov"),
         {"memory_stream_segments"}),
        ("quantized kernel", q_exp, spec_path("quantized", q_opts, 0),
         {"fused_dequant_aggregate"}),
        ("quantized segmented", q_seg, spec_path("quantized", q_opts, 1),
         {"row_stream_segments"}),
        ("clustered kernel", cl_runs["kernel"][0], lambda: clustered_exp(
            "kernel", 0, ClusteredStaticChannel(cmodel, seed=0)), {"block_fused_aggregate"}),
        ("clustered segmented", cl_runs["segmented"][0], lambda: clustered_exp(
            "kernel", 1, ClusteredStaticChannel(cmodel, seed=0)), {"block_row_stream_segments"}),
        ("population kernel", pop_k, lambda: population_exp("kernel"), {"block_fused_aggregate"}),
    )
    for label, ref, make, expect in chunk_paths:
        drive_chunked(label, ref, make, expect)

    # the colrel kernel path: s/round per round and chunked (K = CHUNK_K), in
    # turns, after an unmeasured round and an unmeasured chunk (the capture)
    spec_k = ExperimentSpec(model="cifar_cnn_full", strategy="colrel",
                            strategy_options={"fused": "kernel"})
    per_exp, ch_exp = build_experiment(spec_k), build_experiment(spec_k)
    per_exp.run(1)
    ch_exp.run(CHUNK_K, chunk=CHUNK_K)
    torch.cuda.synchronize()

    def per_round_s():
        out = []
        for _ in range(CHUNK_K):
            t = time.perf_counter()
            per_exp.run(1)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    def chunked_s():
        t = time.perf_counter()
        ch_exp.run(CHUNK_K, chunk=CHUNK_K)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / CHUNK_K

    per_a, ch_a, ch_b, per_b = per_round_s(), chunked_s(), chunked_s(), per_round_s()
    per_med = statistics.median(per_a + per_b)
    print(f"[chunk] colrel kernel path s/round, in turns: per round {[round(x, 4) for x in per_a]}, "
          f"chunked (K={CHUNK_K}) {ch_a:.4f}, {ch_b:.4f}, per round "
          f"{[round(x, 4) for x in per_b]}; median per round {per_med:.4f} s, chunked "
          f"{statistics.mean([ch_a, ch_b]):.4f} s ({per_med / statistics.mean([ch_a, ch_b]):.2f}x); "
          f"{engine_line(ch_exp.trainer._scan_fn)} [{card}]")
    # one replayed chunk under the profiler: the device's busy share, and the
    # aggregation kernel's launches in the trace against captured x replays
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        ch_exp.run(CHUNK_K, chunk=CHUNK_K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    chunk_kernels = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in chunk_kernels) / 1e3
    seen = sum(e.count for e in chunk_kernels if "fused_aggregate_kernel" in e.key)
    per_chunk = ch_exp.trainer._scan_fn.stats["captured_launches"]["fused_aggregate_cuda"] * CHUNK_K
    check(seen == per_chunk, f"the profiler saw fused_aggregate_kernel {seen} times in a "
          f"replayed chunk, captured x replays is {per_chunk}")
    print(f"[chunk] one replayed chunk of {CHUNK_K} rounds under torch.profiler: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in chunk_kernels)} device kernels; fused_aggregate_kernel "
          f"{seen} in the trace = {per_chunk} captured x replays [{card}]")
    del per_exp, ch_exp, prof, chunk_kernels
    torch.cuda.empty_cache()

    # no_trace: the taus drawn inside the captured round, on the static and
    # the Markov channel, held to finite params and a participation within
    # the channel's support (the clients whose uplink can and must succeed)
    for channel in ("static", "markov"):
        exp = build_experiment(spec_k.replace(channel=channel))
        t = time.perf_counter()
        exp.run(ROUNDS, chunk=ROUNDS, no_trace=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        p_up = exp.link_model.p
        lo, hi = int((p_up >= 1).sum()), int((p_up > 0).sum())
        part = exp.log.participation
        check(all(v == int(v) and lo <= v <= hi for v in part),
              f"no_trace {channel}: participation {part} outside [{lo}, {hi}]")
        check(all(bool(torch.isfinite(x).all()) for x in tree.leaves(exp.params)),
              f"no_trace {channel}: non-finite params")
        scan = exp.trainer._sampled_scan_fn
        print(f"[chunk] no_trace on the {channel} channel: one chunk of {ROUNDS} rounds with the "
              f"taus drawn in the captured round: participation {part} in [{lo}, {hi}], "
              f"loss {exp.log.loss}, params finite; launches a round "
              f"{short(scan.stats['captured_launches'])}; {engine_line(scan)}; chunk "
              f"{secs:.2f} s [{card}]")
        del exp, scan
        torch.cuda.empty_cache()

    # -- 4c. the other round modes and async relaying -------------------------
    # cifar_cnn_full at the paper's widths (n=10, d=272,282) from one init, on
    # the same batches and taus; the mode and async checks at T=1 and the
    # timings at the paper's T=8 where the path has a T (see MODE_REL_L2)
    t4c = time.perf_counter()
    from repro_torch.fl.round import ASYNC_METRIC_KEYS, RoundConfig, make_round_fn

    def full_spec(**kw):
        return lambda: build_experiment(ExperimentSpec(model="cifar_cnn_full", **kw))

    def rel_l2_params(a, b):
        num = sum(float(torch.sum((x - y).double() ** 2))
                  for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)))
        return math.sqrt(num / sum(float(torch.sum(y.double() ** 2))
                                   for y in tree.leaves(b.params)))

    def held_to(label, exp, ref, tol):
        """Participation, uplink_bits and weight_sum equal, params within
        ``tol`` relative L2."""
        for field in ("participation", "uplink_bits", "weight_sums"):
            check(getattr(exp.log, field) == getattr(ref.log, field),
                  f"{label}: {field} {getattr(exp.log, field)} != {getattr(ref.log, field)}")
        r = rel_l2_params(exp, ref)
        check(r <= tol, f"{label}: params relative L2 {r:.3e} > {tol}")
        print(f"[modes] {label}: participation, uplink_bits and weight_sum equal; params "
              f"relative L2 {r:.3e} (limit {tol}); loss {exp.log.loss} vs {ref.log.loss}")

    # client_sequential against the per_client colrel collapse path of phase 4
    seq_make = full_spec(mode="client_sequential")
    seq_exp, _ = drive("client_sequential", "colrel", {}, 0, expect={}, make=seq_make)
    held_to("client_sequential vs per_client collapse", seq_exp, col_exp, MODE_REL_L2)
    # weighted_grad against per_client at T = 1
    wg_make = full_spec(mode="weighted_grad", local_steps=1)
    pc1_make = full_spec(strategy_options={"fused": "collapse"}, local_steps=1)
    wg_exp, _ = drive("weighted_grad T=1", "colrel", {}, 0, expect={}, make=wg_make)
    pc1_exp, _ = drive("per_client T=1 collapse", "colrel", {"fused": "collapse"}, 0, expect={},
                       make=pc1_make)
    held_to("weighted_grad vs per_client at T=1", wg_exp, pc1_exp, MODE_REL_L2)
    drive_chunked("client_sequential", seq_exp, seq_make, set())
    drive_chunked("weighted_grad T=1", wg_exp, wg_make, set())
    del wg_exp, pc1_exp
    print(f"[modes] the round modes' checks took {time.perf_counter() - t4c:.1f} s")
    t_async = time.perf_counter()

    # async colrel under Markov blockage without the relay rescue, so that
    # ages grow: the kernel, segmented and plain paths
    async_kw = dict(mode="async", async_options=ASYNC_OPTIONS, channel="markov", local_steps=1)
    async_paths = {"kernel": (dict(strategy_options={"fused": "kernel"}), {"fused_aggregate"}),
                   "segmented": (dict(strategy_options={"fused": "kernel"}, segment_d=1),
                                 {"row_stream"}),
                   "plain": (dict(), set())}
    async_runs = {}
    for label, (kw, expect) in async_paths.items():
        make = full_spec(**async_kw, **kw)
        async_runs[label] = (drive(f"async {label}", "async_colrel", ASYNC_OPTIONS,
                                   kw.get("segment_d", 0), channel="markov",
                                   expect={k: ROUNDS for k in expect}, make=make)[0], make, expect)
    a_k = async_runs["kernel"][0]
    ages = {k: e.trainer.agg_state["age"] for k, (e, _, _) in async_runs.items()}
    check(max(a_k.trainer.round_metrics["max_age"]) > 0,
          f"async: no age grew {a_k.trainer.round_metrics['max_age']}")
    for label in ("segmented", "plain"):
        other = async_runs[label][0]
        check(torch.equal(ages[label], ages["kernel"]), f"async {label}: ages differ")
        for k in ASYNC_METRIC_KEYS:
            check(other.trainer.round_metrics[k] == a_k.trainer.round_metrics[k],
                  f"async {label}: {k} differs from the kernel path's")
    compare("async kernel", a_k, (("segmented", async_runs["segmented"][0], PARAM_ATOL),
                                  ("fused=False", async_runs["plain"][0], PARAM_ATOL)))
    print(f"[async] ages after {ROUNDS} rounds {ages['kernel'].tolist()}, equal on every path; "
          + "; ".join(f"{k} {a_k.trainer.round_metrics[k]}" for k in ASYNC_METRIC_KEYS)
          + ", bitwise equal on every path")

    # one zero-blockage round (all-ones tau_up into the round function)
    # through the kernel path against sync colrel's kernel round, from the
    # async kernel run's params, fresh optimizer and strategy states
    zt = a_k.trainer
    z_sync = make_round_fn(*zt._opts, RoundConfig(n_clients=n, local_steps=1,
                                                 aggregation=strategies.get("colrel",
                                                                            fused="kernel")))
    zb = {k: v[0] for k, v in zt._stack_batches(1).items()}
    z_dd = torch.as_tensor(zt.channel.tau_for_round(0)[1], dtype=torch.float32, device=dev)
    z_up = torch.ones(n, device=dev)
    z_opt = zt._opts[2]
    zp, _, _, zm = zt._round_fn(zt.params, z_opt.init(zt.params),
                                zt.strategy.init_state(n, d_full, device=dev), zb, z_up, z_dd,
                                zt.A)
    sp, _, _, sm = z_sync(zt.params, z_opt.init(zt.params), (), zb, z_up, z_dd, zt.A)
    check(all(torch.equal(a, b) for a, b in zip(tree.leaves(zp), tree.leaves(sp))),
          "zero-blockage async round: params differ from sync colrel's")
    check(all(torch.equal(zm[k], sm[k]) for k in ("loss", "delta_norm", "participation",
                                                  "uplink_bits"))
          and float(zm["max_age"]) == 0.0, "zero-blockage async round: metrics differ")
    print("[async] a zero-blockage round through the kernel path: params, loss, delta_norm, "
          "participation and uplink_bits bitwise equal to sync colrel's kernel round; every age 0")
    del z_sync, zb, zp, sp

    # each async path once more as one chunk of ROUNDS, and with no_trace
    # (taus drawn inside the captured round) per round against one chunk
    for label, (ref, make, expect) in async_runs.items():
        drive_chunked(f"async {label}", ref, make, expect)
    for label, (_, make, expect) in async_runs.items():
        per, one = make(), make()
        per.run(ROUNDS, no_trace=True)
        one.run(ROUNDS, chunk=ROUNDS, no_trace=True)
        same_run(f"async {label} no_trace", per, one)
        captured = short(one.trainer._sampled_scan_fn.stats["captured_launches"])
        check(captured == {k: 1 for k in expect}, f"async {label} no_trace: captured {captured}")
        print(f"[async] {label} no_trace: {ROUNDS} rounds one per call against one chunk, bitwise "
              f"with all {len(one.trainer.round_metrics)} metrics; ages "
              f"{one.trainer.round_metrics['max_age']} (max); launches a round {captured} [{card}]")
        del per, one
    torch.cuda.empty_cache()

    # the n=1024 population under async relaying: the block form of the
    # delivery mask at C=64 x m=16, through kernel 8
    pop_async, _ = drive("population async", "async_clustered", ASYNC_OPTIONS, 0,
                         channel="ClusteredStaticChannel n=1024 C=64 m=16",
                         expect={"block_fused_aggregate": ROUNDS},
                         make=lambda: population_exp("kernel", mode="async",
                                                     async_options=ASYNC_OPTIONS),
                         layout=(1, P_D))
    pm = pop_async.trainer.round_metrics
    check(max(pm["max_age"]) > 0, f"population async: no age grew {pm['max_age']}")
    print(f"[async] population n=1024 (C=64 x m=16): max_age {pm['max_age']}, mean_age "
          f"{pm['mean_age']}, stale_frac {pm['stale_frac']}")
    del pop_async
    print(f"[async] the async checks took {time.perf_counter() - t_async:.1f} s")

    # seconds a round, per round and chunked at K = CHUNK_K, beside the
    # per_client colrel kernel path's figures of phase 4b in this call
    def chunked_round_s(make):
        """The first chunk's s/round (warm-up, capture, instantiate and K
        replays) and the second's (K replays)."""
        exp = make()
        out = []
        for _ in range(2):
            t = time.perf_counter()
            exp.run(CHUNK_K, chunk=CHUNK_K)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) / CHUNK_K)
        del exp
        torch.cuda.empty_cache()
        return out

    def rounds_s(make):
        exp = make()
        out = []
        for _ in range(ROUNDS):
            t = time.perf_counter()
            exp.run(1)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    t_timed = time.perf_counter()
    timed = {
        "per_client colrel kernel T=8": (per_a + per_b, [None, ch_a, ch_b]),
        "client_sequential T=8": (round_s["client_sequential"], chunked_round_s(seq_make)),
        "async colrel kernel T=8": (rounds_s(full_spec(**dict(async_kw, local_steps=8),
                                                          strategy_options={"fused": "kernel"})),
                                    chunked_round_s(full_spec(**dict(async_kw, local_steps=8),
                                                              strategy_options={"fused": "kernel"}))),
        "weighted_grad T=1": (round_s["weighted_grad T=1"], chunked_round_s(wg_make)),
        "per_client collapse T=1": (round_s["per_client T=1 collapse"],
                                    chunked_round_s(pc1_make)),
    }
    for label, (per, (first, *steady)) in timed.items():
        print(f"[modes] s/round {label}: per round {[round(x, 4) for x in per]} (median "
              f"{statistics.median(per):.4f}), chunked K={CHUNK_K} "
              f"{[round(x, 4) for x in steady]} (mean {statistics.mean(steady):.4f})"
              + ("" if first is None else f", the first chunk (with the capture) {first:.4f}")
              + f" [{card}]")
    print(f"[modes] the timings took {time.perf_counter() - t_timed:.1f} s")

    # weighted_flat against weighted_grad on jamba's smoke config without
    # experts (one round each, the inputs of the reference's test)
    t_wf = time.perf_counter()
    from repro_torch.configs.base import get_arch
    from repro_torch.core.connectivity import sample_round
    from repro_torch.models import build as build_model

    wf_cfg = get_arch(JAMBA).smoke().replace(moe_every=0)
    wf_bundle = build_model(wf_cfg)
    wf_params = wf_bundle.init(torch.Generator(device=dev).manual_seed(0))
    wn, wB, wS = 4, 2, 32
    wrng = np.random.default_rng(0)
    wtu, wtd = sample_round(topology.fully_connected(wn, 0.6, p_c=0.8), wrng)
    wtoks = torch.as_tensor(wrng.integers(0, wf_cfg.vocab_size, size=(wn, wB, wS + 1)),
                            device=dev)
    wf_out = {}
    for mode in ("weighted_grad", "weighted_flat"):
        rc = RoundConfig(n_clients=wn, local_steps=1, mode=mode,
                         aggregation=strategies.get("colrel", fused="collapse"))
        server = sgd_momentum(1.0, beta=0.0)
        fn = make_round_fn(wf_bundle.loss_fn, sgd(0.1), server, rc)
        b = {"tokens": wtoks[..., :-1], "labels": wtoks[..., 1:]}
        if mode == "weighted_flat":
            b = {k: v.reshape(wn * wB, wS) for k, v in b.items()}
        wf_out[mode] = fn(wf_params, server.init(wf_params), (), b,
                          torch.as_tensor(wtu, dtype=torch.float32, device=dev),
                          torch.as_tensor(wtd, dtype=torch.float32, device=dev),
                          torch.eye(wn, device=dev) * 2.0)
    wf_diff = max(float(((a - b).abs() - (2e-5 + 2e-4 * b.abs())).max())
                  for a, b in zip(tree.leaves(wf_out["weighted_flat"][0]),
                                  tree.leaves(wf_out["weighted_grad"][0])))
    check(wf_diff <= 0, f"weighted_flat vs weighted_grad on jamba smoke: {wf_diff} past the limit")
    print(f"[modes] weighted_flat vs weighted_grad, jamba smoke (moe_every=0), one round: params "
          f"within atol 2e-5 + rtol 2e-4; losses {float(wf_out['weighted_flat'][3]['loss']):.6f} "
          f"vs {float(wf_out['weighted_grad'][3]['loss']):.6f}")
    del wf_out, wf_params, wf_bundle
    torch.cuda.empty_cache()
    print(f"[modes] weighted_flat's check took {time.perf_counter() - t_wf:.1f} s")
    print(f"[modes] phase 4c wall {time.perf_counter() - t4c:.1f} s [{card}]")

    # -- 4d. mobility, adaptive alpha, multihop and the sparsifying codecs ---
    # cifar_cnn_full at the paper's widths from one init; the checks at T=1
    # (the channel, the estimator and the aggregation do not depend on T),
    # the timings at the paper's T=8
    t4d = time.perf_counter()
    import copy

    from repro_torch import wire
    from repro_torch.channel import MobilityChannel

    def adaptive_same(label, ref, exp):
        """The adaptive logs, the estimator's posterior and the swapped-in
        alpha of two runs, bitwise."""
        for field in ("reopt_rounds", "S_est", "S_true", "est_p_err"):
            check(getattr(exp.log, field) == getattr(ref.log, field),
                  f"{label}: {field} {getattr(exp.log, field)} != {getattr(ref.log, field)}")
        post, ref_post = (e.trainer.adaptive.estimator.checkpoint_state() for e in (exp, ref))
        check(all(np.array_equal(post[k], ref_post[k]) for k in post),
              f"{label}: the estimator's posterior (the taus it saw) differs")
        check(np.array_equal(exp.trainer.channel.positions, ref.trainer.channel.positions),
              f"{label}: the clients' positions differ")
        check(torch.equal(exp.trainer.A, ref.trainer.A), f"{label}: the final alpha differs")

    # adaptive mobility through the three kernel paths, 8 rounds, re-opts at
    # rounds 3 and 7 (warm-up min(4, 20) = 4 rounds)
    mob_kw = dict(channel="mobility", adaptive=True, reopt_every=MOB_REOPT, local_steps=1)
    mob_paths = {"kernel": (dict(strategy_options={"fused": "kernel"}), "fused_aggregate"),
                 "segmented": (dict(strategy_options={"fused": "kernel"}, segment_d=1),
                               "row_stream_segments"),
                 "collapse": (dict(strategy_options={"fused": "collapse"}), None)}
    mob_runs = {}
    for label, (kw, kernel) in mob_paths.items():
        make = full_spec(**mob_kw, **kw)
        mob_runs[label] = drive(f"adaptive mobility {label}", "colrel",
                                kw["strategy_options"], kw.get("segment_d", 0),
                                channel="mobility", rounds=MOB_ROUNDS, make=make,
                                expect={} if kernel is None else {kernel: MOB_ROUNDS})[0]
    m_k = mob_runs["kernel"]
    check(m_k.log.reopt_rounds == [3, 7], f"adaptive mobility: re-opts at {m_k.log.reopt_rounds}")
    check(np.array_equal(m_k.A, np.eye(n)) and not torch.equal(
        m_k.trainer.A, torch.eye(n, device=dev)) and bool(torch.isfinite(m_k.trainer.A).all()),
          "adaptive mobility: the blind start alpha was not swapped for a finite COPT-alpha")
    for label in ("segmented", "collapse"):
        adaptive_same(f"adaptive mobility {label}", m_k, mob_runs[label])
    compare("adaptive mobility kernel", m_k, (("segmented", mob_runs["segmented"], PARAM_ATOL),
                                              ("collapse", mob_runs["collapse"], PARAM_ATOL)),
            rounds=MOB_ROUNDS)
    print(f"[mobility] adaptive mobility, {MOB_ROUNDS} rounds on every path: the same taus "
          f"(estimator posterior and positions bitwise), re-opts at {m_k.log.reopt_rounds}, "
          f"S_est {m_k.log.S_est}, S_true {m_k.log.S_true}, est_p_err {m_k.log.est_p_err}, "
          f"the final alpha bitwise equal; participation {m_k.log.participation}")

    # the kernel path as 2 chunks of K = MOB_REOPT: each new alpha reaches the
    # replayed round through the static A buffer, from one capture
    for w_ in wrappers.values():
        w_.launches = 0
    m_ch = full_spec(**mob_kw, **mob_paths["kernel"][0])()
    m_ch.run(MOB_ROUNDS, chunk=MOB_REOPT)
    torch.cuda.synchronize()
    st = m_ch.trainer._scan_fn.stats
    check(st["captures"] == 1 and st["replays"] == MOB_ROUNDS
          and st["captured_launches"] == {"fused_aggregate_cuda": 1},
          f"adaptive mobility chunked: {st['captures']} captures, {st['replays']} replays, "
          f"captured launches {st['captured_launches']}")
    same_run("adaptive mobility chunked", m_k, m_ch, rounds=MOB_ROUNDS)
    adaptive_same("adaptive mobility chunked", m_k, m_ch)
    print(f"[mobility] the kernel path as {MOB_ROUNDS // MOB_REOPT} chunks of {MOB_REOPT}: bitwise "
          f"the per-round run with both alpha swaps, {st['captures']} capture, {st['replays']} "
          f"replays, kernel launches {wrappers['fused_aggregate'].launches} (the warm-up's and "
          f"the captured round's); {engine_line(m_ch.trainer._scan_fn)} [{card}]")
    del mob_runs, m_ch
    torch.cuda.empty_cache()

    # mobility_fast with oracle COPT-alpha from the channel's round-0 model,
    # through kernel 1
    fast_make = full_spec(channel="mobility_fast", strategy_options={"fused": "kernel"},
                          local_steps=1)
    fast, _ = drive("mobility_fast kernel", "colrel", {"fused": "kernel"}, 0,
                    channel="mobility_fast", rounds=4, make=fast_make,
                    expect={"fused_aggregate": 4})
    oracle = optimize_weights(fast.trainer.channel.model_for_round(0), sweeps=30,
                              fine_tune_sweeps=30).A
    check(fast.copt_result is not None and np.array_equal(fast.A, oracle),
          "mobility_fast: alpha is not COPT-alpha of the channel's round-0 model")
    check(fast.trainer.channel.epoch == 10 and fast.trainer.channel.speed == 15.0,
          "mobility_fast: not the preset's epoch and speed")
    print(f"[mobility] mobility_fast (epoch 10, 15 m a round), 4 rounds, oracle COPT-alpha "
          f"(S={fast.copt_result.S:.4f}): participation {fast.log.participation}")
    del fast

    # multihop, K = 2, calibrated; and K = 1 against colrel's collapse, bitwise
    hop_make = full_spec(strategy="multihop", strategy_options={"hops": 2}, local_steps=1)
    hop, _ = drive("multihop K=2", "multihop", {"hops": 2}, 0, expect={}, make=hop_make)
    check(hop.strategy.correction is not None, "multihop: build_experiment did not calibrate")
    drive_chunked("multihop K=2", hop, hop_make, set())

    def uncalibrated(strategy):
        """The default spec's run at T=1 with ``strategy`` as it is (the K=1
        contract is for uncalibrated multihop; build_experiment calibrates)."""
        spec = ExperimentSpec(model="cifar_cnn_full", local_steps=1)
        loss_fn, init, clients, client_opt, server_opt, steps, _ = build_task(spec, n)
        trainer = FLTrainer(loss_fn, init, fig2b, kernel_exp.A, clients, client_opt,
                            server_opt, local_steps=steps, strategy=strategy,
                            channel=StaticChannel(fig2b, seed=0))
        return Experiment(spec=spec, trainer=trainer, link_model=fig2b, A=kernel_exp.A,
                          strategy=strategy)

    hop1, _ = drive("multihop K=1", "multihop", {"hops": 1}, 0, expect={},
                    make=lambda: uncalibrated(strategies.get("multihop", hops=1)))
    col1, _ = drive("colrel collapse T=1", "colrel", {"fused": "collapse"}, 0, expect={},
                    make=lambda: uncalibrated(strategies.get("colrel", fused="collapse")))
    check(hop1.log.weight_sums == col1.log.weight_sums and all(
        torch.equal(a, b) for a, b in zip(tree.leaves(hop1.params), tree.leaves(col1.params))),
        "multihop K=1: params or weight_sum differ from colrel's collapse")
    print(f"[multihop] K=2 calibrated (correction {np.round(hop.strategy.correction, 4).tolist()}),"
          f" weight_sum {hop.log.weight_sums}; K=1 bitwise colrel's collapse over {ROUNDS} rounds")
    del hop, hop1, col1

    # the sparsifying codecs through quantized relaying
    for codec, fraction in (("topk", 0.1), ("randk", 0.25)):
        opts = {"codec": codec, "codec_options": {"fraction": fraction}}
        make = full_spec(strategy="quantized", strategy_options=opts, local_steps=1)
        q_run, _ = drive(f"quantized {codec}", "quantized", opts, 0, expect={}, make=make)
        bits = wire.get(codec, fraction=fraction).descriptor(d_full).bits_per_coord
        want = [float(np.float32(p) * np.float32(d_full * bits))
                for p in q_run.log.participation]
        check(q_run.log.uplink_bits == want,
              f"quantized {codec}: uplink_bits {q_run.log.uplink_bits}, the descriptor's {want}")
        drive_chunked(f"quantized {codec}", q_run, make, set())
        print(f"[sparse] {codec} (fraction {fraction}): {bits:.4f} bits a coordinate, uplink_bits "
              f"{q_run.log.uplink_bits} as the descriptor gives them; loss {q_run.log.loss}")
        del q_run

    # no_trace: mobility has no in-scan sampler
    nt = full_spec(channel="mobility", local_steps=1)()
    try:
        nt.run(1, no_trace=True)
    except ValueError as e:
        print(f"[mobility] no_trace on mobility raises ValueError: {e}")
    else:
        check(False, "no_trace on mobility did not raise")
    del nt
    torch.cuda.empty_cache()
    print(f"[mobility] the checks took {time.perf_counter() - t4d:.1f} s")

    # s/round at T = 8, per round and chunked (K = MOB_REOPT), the adaptive
    # mobility kernel path in turns with phase 4b's colrel kernel path; and
    # the host seconds of one re-optimization
    t_mt = time.perf_counter()
    timed_paths = {"colrel kernel": full_spec(strategy_options={"fused": "kernel"}),
                   "adaptive mobility kernel": full_spec(
                       **dict(mob_kw, local_steps=8), strategy_options={"fused": "kernel"})}
    per_e = {k: make() for k, make in timed_paths.items()}
    ch_e = {k: make() for k, make in timed_paths.items()}
    for k in timed_paths:  # an unmeasured round, and an unmeasured chunk (the capture)
        per_e[k].run(1)
        ch_e[k].run(MOB_REOPT, chunk=MOB_REOPT)
    torch.cuda.synchronize()
    per_t = {k: [] for k in timed_paths}
    ch_t = {k: [] for k in timed_paths}

    def per_turn(k):
        t = time.perf_counter()
        per_e[k].run(1)
        torch.cuda.synchronize()
        per_t[k].append(time.perf_counter() - t)

    def chunk_turn(k):
        t = time.perf_counter()
        ch_e[k].run(MOB_REOPT, chunk=MOB_REOPT)
        torch.cuda.synchronize()
        ch_t[k].append((time.perf_counter() - t) / MOB_REOPT)

    order = list(timed_paths)
    for k in order:
        per_turn(k)
    for k in order + order[::-1]:
        chunk_turn(k)
    for k in order[::-1]:
        per_turn(k)
    sched = ch_e["adaptive mobility kernel"].trainer.adaptive
    check(ch_e["adaptive mobility kernel"].trainer._scan_fn.stats["captures"] == 1,
          "adaptive mobility timing: the chunks captured more than once")
    ups, dds = MobilityChannel(n, seed=9).tau_for_round(0)
    reopt_s = []
    for _ in range(3):
        s_copy = copy.deepcopy(sched)
        t = time.perf_counter()
        A_new = s_copy.step(MOB_REOPT - 1, ups, dds)
        reopt_s.append(time.perf_counter() - t)
        check(A_new is not None, "the timed re-optimization did not fire")
    for k in order:
        print(f"[mobility] s/round {k} T=8, in turns: per round "
              f"{[round(x, 4) for x in per_t[k]]} (median {statistics.median(per_t[k]):.4f}), "
              f"chunked K={MOB_REOPT} {[round(x, 4) for x in ch_t[k]]} (mean "
              f"{statistics.mean(ch_t[k]):.4f}) [{card}]")
    print(f"[mobility] one re-optimization on the host (estimator update, projection, COPT-alpha "
          f"{sched.cfg.sweeps} + {sched.cfg.fine_tune_sweeps} sweeps at n={n}): "
          f"{[round(x, 4) for x in reopt_s]} s (median {statistics.median(reopt_s):.4f}); "
          f"re-opts in the timed runs at {ch_e['adaptive mobility kernel'].log.reopt_rounds}")
    del per_e, ch_e
    torch.cuda.empty_cache()
    print(f"[mobility] the timings took {time.perf_counter() - t_mt:.1f} s")
    print(f"[mobility] phase 4d wall {time.perf_counter() - t4d:.1f} s [{card}]")

    # -- 4e. telemetry and checkpoint/resume --------------------------------------
    # cifar_cnn_full at the paper's widths from one init; the bitwise checks at
    # T=1 (the streak, the vectors and the carry do not depend on T), the
    # timings at T=8.  Checkpoints go to build/ckpt_4e, removed at the end.
    t4e = time.perf_counter()
    import shutil

    from repro_torch.ckpt import CheckpointWriter
    from repro_torch.telemetry import VECTOR_METRICS

    ck_root = ROOT / "build" / "ckpt_4e"
    shutil.rmtree(ck_root, ignore_errors=True)

    def counted_run(label, exp, rounds, expect, **run_kw):
        """``exp.run(rounds, **run_kw)`` with every launch count set to 0 just
        before and read just after; ``expect`` names the counts."""
        for w_ in wrappers.values():
            w_.launches = 0
        t = time.perf_counter()
        exp.run(rounds, **run_kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launched = {k: w_.launches for k, w_ in wrappers.items() if w_.launches}
        check(launched == expect, f"{label}: launches {launched}, expected {expect}")
        check(all(math.isfinite(v) for v in exp.log.loss), f"{label}: loss {exp.log.loss}")
        return secs

    def final_state(exp):
        """A run's end, copied: the carry is the engine's static buffers,
        which a later chunk overwrites."""
        tr = exp.trainer
        return dict(
            metrics={k: list(v) for k, v in tr.round_metrics.items()},
            log=tr.log.to_dict(),
            vectors={k: tr.metrics.vector(k) for k in VECTOR_METRICS},
            state=[(x.get_state() if isinstance(x, torch.Generator) else x.clone())
                   for x in tree.leaves((tr.params, tr.server_state, tr.agg_state, tr._streak,
                                         tr._channel_state, tr._channel_gen))
                   if x is not None],
            round=tr.round)

    def same_end(label, want, exp, keys=None):
        """Every round metric (of ``keys``, default all), the TrainLog, the
        vectors and the carry (params, server and strategy state, streak,
        the sampler's state and generator) bitwise."""
        got = final_state(exp)
        for k in keys or want["metrics"]:
            x, y = want["metrics"][k], got["metrics"][k]
            check(len(x) == len(y) and all(u == v or (math.isnan(u) and math.isnan(v))
                                           for u, v in zip(x, y)), f"{label}: {k} {y} != {x}")
        if keys is None:
            check(got["round"] == want["round"] and got["log"]["rounds"] == want["log"]["rounds"],
                  f"{label}: rounds differ")
            for k, v in want["vectors"].items():
                check(v is not None and got["vectors"][k].dtype == v.dtype
                      and np.array_equal(got["vectors"][k], v), f"{label}: {k} differs")
        check(len(got["state"]) >= len(want["state"]), f"{label}: carry leaves differ")
        for a, b in zip(want["state"], got["state"]):
            check(a.dtype == b.dtype and torch.equal(a, b), f"{label}: the carry differs")

    # (a) telemetry on the colrel kernel path: on against off, per round and as
    # one chunk of CHUNK_K, from one init (off chunked == off per round is
    # phase 4b's)
    tel = {}
    for label, on, chunk in (("off, per round", False, 1), ("on, per round", True, 1),
                             ("on, chunked", True, CHUNK_K)):
        exp = full_spec(strategy_options={"fused": "kernel"}, local_steps=1, telemetry=on)()
        counted_run(f"telemetry {label}", exp, CHUNK_K,
                    {"fused_aggregate": CHUNK_K if chunk == 1 else 2}, chunk=chunk)
        tel[label] = exp
    off_keys = list(tel["off, per round"].trainer.round_metrics)
    off_end = final_state(tel["off, per round"])
    on_end = final_state(tel["on, per round"])
    for label in ("on, per round", "on, chunked"):
        same_end(f"telemetry {label} vs off, per round", off_end, tel[label], keys=off_keys)
    same_end("telemetry on, chunked vs on, per round", on_end, tel["on, chunked"])
    on = tel["on, chunked"].trainer
    part, streak = on.metrics.vector("client_participation"), on.metrics.vector("outage_streak")
    roll, ages = np.zeros(n, np.int32), []
    for row in part:
        roll = np.where(row > 0, 0, roll + 1).astype(np.int32)
        ages.append(roll)
    check(np.array_equal(part.sum(axis=1), np.asarray(on.log.participation))
          and np.array_equal(streak, np.stack(ages)) and streak.dtype == np.int32
          and on._streak.dtype == torch.int32 and on._streak.is_cuda,
          "telemetry: the vectors do not reduce to participation or the streak recurrence")
    st = on._scan_fn.stats
    check(st["captures"] == 1 and st["captured_launches"] == {"fused_aggregate_cuda": 1},
          f"telemetry chunked: {st['captures']} captures, launches {st['captured_launches']}")
    print(f"[telemetry] colrel kernel T=1, {CHUNK_K} rounds: on bitwise off (params, server state, "
          f"strategy state, every scalar), per round and as one chunk; on chunked bitwise on per "
          f"round with the vectors and the streak; participation vectors {part.astype(int).tolist()}"
          f", streak {streak.tolist()}, weight_drift {on.round_metrics['weight_drift']}; "
          f"{engine_line(on._scan_fn)} [{card}]")
    del tel, on
    torch.cuda.empty_cache()

    # (b) kill/resume at round CHUNK_K of 2 * CHUNK_K rounds, with telemetry, on
    # the memory kernel path (kernel 4), int8 quantized (kernel 6, its codec's
    # generator on the card) and no_trace (the sampler's CUDA generator); a
    # fresh trainer resumes, then the captured uninterrupted trainer restores
    res_rounds = 2 * CHUNK_K
    res_paths = {
        "memory kernel, markov": (dict(strategy="memory", strategy_options={"fused": "kernel"},
                                       channel="markov"), {}, "fused_memory_update"),
        "int8 quantized kernel": (dict(strategy="quantized",
                                       strategy_options={"codec": "int8", "fused": "kernel"}),
                                  {}, "fused_dequant_aggregate"),
        "colrel kernel, no_trace on markov": (dict(strategy_options={"fused": "kernel"},
                                                   channel="markov"), {"no_trace": True},
                                              "fused_aggregate"),
    }
    for label, (kw, run_kw, kernel) in res_paths.items():
        d = ck_root / kernel
        ref = full_spec(**kw, local_steps=1, telemetry=True, ckpt_dir=str(d),
                        ckpt_every=CHUNK_K)()
        counted_run(f"{label}: uninterrupted", ref, res_rounds, {kernel: 2}, chunk=CHUNK_K,
                    **run_kw)
        check(CheckpointWriter(d).steps() == [CHUNK_K, res_rounds],
              f"{label}: committed steps {CheckpointWriter(d).steps()}")
        want = final_state(ref)
        recs = list(ref.trainer.ckpt_records)
        mid = CheckpointWriter(d).path_for(CHUNK_K)
        res = full_spec(**kw, local_steps=1, telemetry=True, resume_from=str(mid))()
        counted_run(f"{label}: resumed", res, res_rounds, {kernel: 2}, chunk=CHUNK_K, **run_kw)
        same_end(f"{label}: resumed", want, res)
        scan = res.trainer._sampled_scan_fn if run_kw else res.trainer._scan_fn
        rst = dict(scan.stats)
        check(rst["captures"] == 1 and rst["replays"] == CHUNK_K,
              f"{label}: resumed run {rst['captures']} captures, {rst['replays']} replays")
        ref_scan = ref.trainer._sampled_scan_fn if run_kw else ref.trainer._scan_fn
        caps = ref_scan.stats["captures"]
        counted_run(f"{label}: restored into the captured trainer", ref, res_rounds, {},
                    chunk=CHUNK_K, resume_from=str(mid), **run_kw)
        same_end(f"{label}: restored into the captured trainer", want, ref)
        check(ref_scan.stats["captures"] == caps,
              f"{label}: the restore into a captured trainer captured again")
        print(f"[resume] {label}, T=1, {res_rounds} rounds in chunks of {CHUNK_K}, telemetry on, "
              f"a checkpoint every chunk: a fresh trainer resumed at round {CHUNK_K} ends bitwise "
              f"the uninterrupted run (every metric, the vectors, params, server and strategy "
              f"state, streak, sampler state and generators), {rst['captures']} capture, "
              f"{kernel} launched by its warm-up and capture; its first chunk "
              f"{res.trainer.meter.chunks[0]['seconds']:.3f} s (warm-up {rst['warmup_s']:.3f} s, "
              f"capture {rst['capture_s']:.3f} s, instantiate {rst['instantiate_s']:.3f} s); "
              f"restored into the uninterrupted trainer, which had captured: bitwise again, "
              f"captures still {ref_scan.stats['captures']} (the generators' states written into "
              f"the registered objects are honoured by the replays) [{card}]")
        print(f"[resume] {label}: checkpoints " + "; ".join(
            f"step {r['step']}: {r['bytes']} bytes, the loop blocked {r['block_s'] * 1e3:.2f} ms "
            f"(snapshot {r['snapshot_s'] * 1e3:.2f} ms), commit on the writer thread "
            f"{r['commit_s'] * 1e3:.2f} ms" for r in recs))
        del ref, res, scan, ref_scan
        torch.cuda.empty_cache()
    print(f"[resume] the checks of (a) and (b) took {time.perf_counter() - t4e:.1f} s")

    # (c) s/round of the colrel kernel path at T=8, chunked (K=CHUNK_K), in
    # turns: telemetry off, telemetry on, telemetry off with a checkpoint every
    # chunk (two chunks a turn: the first save overlaps the second chunk, the
    # final one is waited for at the run's end)
    t_tc = time.perf_counter()
    variants = {"telemetry off": dict(), "telemetry on": dict(telemetry=True),
                "off, checkpoint every chunk": dict(ckpt_dir=str(ck_root / "timed"),
                                                    ckpt_every=CHUNK_K, ckpt_keep=2)}
    exps = {k: full_spec(strategy_options={"fused": "kernel"}, **kw)() for k, kw in
            variants.items()}
    for k in variants:  # an unmeasured chunk: the warm-up and the capture
        exps[k].run(CHUNK_K, chunk=CHUNK_K)
    torch.cuda.synchronize()
    secs = {k: [] for k in variants}

    def turn(k):
        t = time.perf_counter()
        exps[k].run(2 * CHUNK_K, chunk=CHUNK_K)
        torch.cuda.synchronize()
        secs[k].append((time.perf_counter() - t) / (2 * CHUNK_K))

    order = list(variants)
    for k in order + order[::-1]:
        turn(k)
    for k in order:
        check(exps[k].trainer._scan_fn.stats["captures"] == 1, f"timing {k}: captured again")
        print(f"[telemetry] s/round colrel kernel T=8 chunked K={CHUNK_K}, {k}, in turns: "
              f"{[round(x, 4) for x in secs[k]]} (mean {statistics.mean(secs[k]):.4f}) [{card}]")
    recs = exps["off, checkpoint every chunk"].trainer.ckpt_records[1:]  # after the warm-up's
    print("[telemetry] the timed saves: " + "; ".join(
        f"step {r['step']}: {r['bytes']} bytes, blocked {r['block_s'] * 1e3:.2f} ms, commit "
        f"{r['commit_s'] * 1e3:.2f} ms" for r in recs) + f" [{card}]")
    del exps
    torch.cuda.empty_cache()
    shutil.rmtree(ck_root, ignore_errors=True)
    print(f"[telemetry] the timings took {time.perf_counter() - t_tc:.1f} s")
    print(f"[telemetry] phase 4e wall {time.perf_counter() - t4e:.1f} s [{card}]")

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
    # kernels 2 and 5 as the segmented paths launch them, one grouped call
    # over the 61 segments (ms), beside the 61 per-segment launches, each
    # timed alone and summed (per_segment_ms); library: one call on the
    # monolithic stack, and the per-segment calls summed
    segs = [s.contiguous() for s in X.split(full_sizes, dim=1)]
    rs_times = dict(
        ms=median_ms(lambda: fa.row_stream_segments_cuda(w, segs), flush, 100),
        per_segment_ms=sum(median_ms(lambda: fa.row_stream_cuda(w, s), flush, 30) for s in segs),
        plain_ms=median_ms(lambda: fa.row_stream_segments_plain(w, segs), flush, 10),
        library_ms=median_ms(lambda: torch.matmul(w, X), flush, 100),
        library_per_segment_ms=sum(median_ms(lambda: torch.matmul(w, s), flush, 30)
                                   for s in segs),
        bound_ms=bound_ms(4 * n + 4 * n * d_full + 4 * d_full, 2 * n * d_full))
    # row_stream on the quantized path's int8 segments
    q8 = (X * 40).round().clamp(-127, 127).to(torch.int8)
    scale = torch.rand(n, 1, device=dev) / 40
    ws = ops.fold_dequant_scales(w, scale)
    q8_segs = [s_.contiguous() for s_ in q8.split(full_sizes, dim=1)]
    rs8_times = dict(
        int8_ms=median_ms(lambda: fa.row_stream_segments_cuda(ws, q8_segs), flush, 100),
        int8_per_segment_ms=sum(median_ms(lambda: fa.row_stream_cuda(ws, s_), flush, 30)
                                for s_ in q8_segs),
        int8_plain_ms=median_ms(lambda: fa.row_stream_segments_plain(ws, q8_segs), flush, 10),
        int8_library_ms=None,
        int8_bound_ms=bound_ms(4 * n + n * d_full + 4 * d_full, 2 * n * d_full))
    rows.append(dict(name="row_stream", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_aggregate.cu",
                     replaces="src/repro/kernels/fused_aggregate.py:105",
                     launches=rs_launches, max_abs_err=max_err["row_stream"],
                     bound_by="bytes", **rs_times, **rs8_times))

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
    ms_times = dict(
        ms=median_ms(lambda: fm.memory_stream_segments_cuda(mix, tu, segs, B), flush, 100),
        per_segment_ms=0.0,
        plain_ms=median_ms(lambda: fm.memory_stream_segments_plain(mix, tu, segs, B), flush, 10),
        library_ms=None,
        bound_ms=bound_ms(4 * n * n + 4 * n + mem_bytes(d_full), mem_ops(d_full)))
    tilde_seg_ms, off = 0.0, 0
    for s_ in segs:
        d_ = s_.shape[1]
        view = B[:, off:off + d_]
        ms_times["per_segment_ms"] += median_ms(lambda: fm.memory_stream_cuda(mix, tu, s_, view),
                                                flush, 30)
        tilde_seg_ms += median_ms(lambda: torch.matmul(mix, s_), flush, 30)
        off += d_
    rows.append(dict(name="memory_stream", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_memory.cu",
                     replaces="src/repro/kernels/fused_memory.py:118",
                     launches=ms_launches, max_abs_err=max_err["memory_stream"],
                     bound_by="bytes", **ms_times))

    # the dequant kernel: the int8 stack read, the (d,) delta written;
    # beside it (a) an empty kernel of its grid, the harness's floor for a
    # lone launch, (b) kernel 2's launch on the same stack with the folded
    # row given (kernel 6 without its collapse), (d) a device copy of the
    # stack
    fdq_grid = fdq.dequant_grid(n, d_full)
    fdq_times = dict(
        ms=median_ms(lambda: fdq.fused_dequant_aggregate_cuda(A, tu, td, q8, scale), flush, 100),
        plain_ms=median_ms(lambda: fdq.fused_dequant_aggregate_plain(A, tu, td, q8, scale),
                           flush, 30),
        library_ms=None,
        bound_ms=bound_ms(small_bytes + 4 * n + n * d_full + 4 * d_full,
                          2 * n * d_full + 4 * n * n),
        floor_ms=median_ms(lambda: fdq.launch_floor_cuda(fdq_grid["blocks"]), flush, 100),
        no_collapse_ms=median_ms(lambda: fa.row_stream_cuda(ws, q8), flush, 100),
        copy_ms=median_ms(lambda: torch.empty_like(q8).copy_(q8), flush, 100),
        grid=fdq_grid)
    two_calls_ms = median_ms(lambda: torch.matmul(ws, q8.float()), flush, 100)
    rows.append(dict(name="fused_dequant_aggregate", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_aggregate.cu",
                     replaces="src/repro/kernels/fused_dequant.py:67",
                     launches=fdq_launches, max_abs_err=max_err["fused_dequant_aggregate"],
                     bound_by="bytes", **fdq_times))

    # the clustered kernels at the clustered cifar_cnn_full path's shapes
    # (n=10 as 2 clusters of 5), and the dense relay mix at the kernel
    # benchmark's (n=16, d=2^20): every X read once, every output written once
    cAb = cl_runs["kernel"][0].trainer.A
    ctu, ctb = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                for t in cl_runs["kernel"][0].trainer.channel.tau_for_round(0))
    Cc, mc = cmodel.C, cmodel.m
    wb = ops.block_collapsed_weight_row(cAb, ctu, ctb)
    wflat = wb.reshape(-1)
    block_small = 4 * (2 * n * mc + n)  # Ab, tau_b, tau_up
    bfa_times = dict(
        ms=median_ms(lambda: rb.block_fused_aggregate_cuda(cAb, ctu, ctb, X), flush, 100),
        plain_ms=median_ms(lambda: rb.block_fused_aggregate_plain(cAb, ctu, ctb, X), flush, 30),
        library_ms=median_ms(lambda: torch.matmul(wflat, X), flush, 100),
        bound_ms=bound_ms(block_small + 4 * n * d_full + 4 * d_full,
                          2 * n * d_full + 3 * n * mc))
    rows.append(dict(name="block_fused_aggregate", route="cuda",
                     source="src/repro_torch/kernels/csrc/relay_block.cu",
                     replaces="src/repro/kernels/relay_block.py:113",
                     launches=bfa_launches, max_abs_err=max_err["block_fused_aggregate"],
                     bound_by="bytes", **bfa_times))
    # kernel 9 as the segmented clustered path launches it, one grouped call
    # over the 61 segments (ms), beside the 61 per-segment launches, each
    # timed alone and summed (per_segment_ms); library: one call on the
    # monolithic stack, and the per-segment calls summed
    brs_times = dict(
        ms=median_ms(lambda: rb.block_row_stream_segments_cuda(wb, segs), flush, 100),
        per_segment_ms=sum(median_ms(lambda: rb.block_row_stream_cuda(wb, s_), flush, 30)
                           for s_ in segs),
        plain_ms=median_ms(lambda: rb.block_row_stream_segments_plain(wb, segs), flush, 10),
        library_ms=median_ms(lambda: torch.matmul(wflat, X), flush, 100),
        library_per_segment_ms=sum(median_ms(lambda: torch.matmul(wflat, s_), flush, 30)
                                   for s_ in segs),
        bound_ms=bound_ms(4 * n + 4 * n * d_full + 4 * d_full, 2 * n * d_full))
    rows.append(dict(name="block_row_stream", route="cuda",
                     source="src/repro_torch/kernels/csrc/relay_block.cu",
                     replaces="src/repro/kernels/relay_block.py:171",
                     launches=brs_launches, max_abs_err=max_err["block_row_stream"],
                     bound_by="bytes", **brs_times))
    Mb = rb.block_mixing_mask(cAb, ctb)
    mixed_bytes = {"block_relay_mix": mix_bytes(Cc, mc, d_full, 2),
                   "relay_mix": mix_bytes(1, MIX_N, MIX_D, 1)}
    brm_times = dict(
        ms=median_ms(lambda: rb.block_relay_mix_cuda(cAb, ctb, X), flush, MIX_REPS),
        plain_ms=median_ms(lambda: rb.block_relay_mix_plain(cAb, ctb, X), flush, 30),
        library_ms=median_ms(lambda: torch.bmm(Mb, X.view(Cc, mc, d_full)), flush, MIX_REPS),
        bound_ms=bound_ms(mixed_bytes["block_relay_mix"], 2 * n * mc * d_full))
    rows.append(dict(name="block_relay_mix", route="cuda",
                     source="src/repro_torch/kernels/csrc/relay_block.cu",
                     replaces="src/repro/kernels/relay_block.py:53",
                     launches=mix_launches["block_relay_mix"],
                     max_abs_err=max_err["block_relay_mix"], bound_by="bytes", **brm_times))
    rmx_times = dict(
        ms=median_ms(lambda: rm.relay_mix_cuda(M16, X16), flush, MIX_REPS),
        plain_ms=median_ms(lambda: rm.relay_mix_plain(M16, X16), flush, 30),
        library_ms=median_ms(lambda: torch.matmul(M16, X16), flush, MIX_REPS),
        bound_ms=bound_ms(mixed_bytes["relay_mix"], 2 * MIX_N * MIX_N * MIX_D))
    rows.append(dict(name="relay_mix", route="cuda",
                     source="src/repro_torch/kernels/csrc/relay_block.cu",
                     replaces="src/repro/kernels/relay_mix.py:43",
                     launches=mix_launches["relay_mix"], max_abs_err=max_err["relay_mix"],
                     bound_by="bytes", **rmx_times))

    whats = {
        "fused_aggregate": "one launch, n=10 d=272282 f32",
        "row_stream": "one launch over the 61 segments of one round, n=10 f32",
        "fused_memory_update": "one launch, n=10 d=272282 f32 stack and buffer",
        "memory_stream": "one launch over the 61 segments of one round into the (n, d) "
                         "buffer, n=10 f32",
        "fused_dequant_aggregate": "one launch, n=10 d=272282 int8",
        "block_fused_aggregate": "one launch (the collapse, then the stream launched behind "
                                 "it), n=10 as C=2 m=5, d=272282 f32",
        "block_row_stream": "one launch over the 61 segments of one round, n=10 as C=2 m=5, f32",
        "block_relay_mix": "one launch, n=10 as C=2 m=5, d=272282 f32",
        "relay_mix": "one launch, n=16 d=2^20 f32 (the kernel benchmark's shape)",
    }
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        rate = (f" ({mixed_bytes[r['name']] / r['ms'] / 1e9:.3f} TB/s; library "
                f"{mixed_bytes[r['name']] / r['library_ms'] / 1e9:.3f} TB/s)"
                if r["name"] in mixed_bytes else "")
        per_seg = (f" (61 launches, each timed alone, summed: {r['per_segment_ms']:.4f} ms)"
                   if "per_segment_ms" in r else "")
        print(f"[time] {r['name']} ({whats[r['name']]}): kernel {r['ms']:.4f} ms{per_seg}{rate}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} [{card}]")
    print(f"[time] row_stream's library_ms is torch.matmul(w, X) on the monolithic stack; "
          f"torch.matmul(w, seg) over the 61 segments, summed: "
          f"{rs_times['library_per_segment_ms']:.4f} ms [{card}]")
    print(f"[time] row_stream on the quantized path's 61 int8 segments: kernel "
          f"{rs8_times['int8_ms']:.4f} ms one launch (61 launches, each timed alone, summed: "
          f"{rs8_times['int8_per_segment_ms']:.4f} ms), bound {rs8_times['int8_bound_ms']:.4f} ms "
          f"(bytes), plain {rs8_times['int8_plain_ms']:.4f} ms, library null: no PyTorch call "
          f"takes the int8 segments [{card}]")
    print(f"[time] memory kernels' library_ms is {no_library}; yardstick of tilde alone, "
          f"torch.matmul(mix, X): {tilde_ms:.4f} ms one launch, {tilde_seg_ms:.4f} ms summed "
          f"over the 61 segments [{card}]")
    print(f"[time] fused_dequant_aggregate's library_ms is null: no single PyTorch call "
          f"takes the int8 stack; two calls, torch.matmul(ws, q.float()): {two_calls_ms:.4f} ms "
          f"[{card}]")
    print(f"[time] fused_dequant_aggregate beside (a) an empty kernel of its grid "
          f"{fdq_times['floor_ms']:.4f} ms, (b) kernel 2 on the same int8 stack with the folded row "
          f"given {fdq_times['no_collapse_ms']:.4f} ms, (c) kernel 6 {fdq_times['ms']:.4f} ms, "
          f"(d) a device copy of the stack {fdq_times['copy_ms']:.4f} ms; grid {fdq_grid} "
          f"[{card}]")
    print(f"[time] block_row_stream's library_ms is torch.matmul(w_flat, X) on the monolithic "
          f"stack; torch.matmul(w_flat, seg) over the 61 segments, summed: "
          f"{brs_times['library_per_segment_ms']:.4f} ms [{card}]")
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

    # -- 7. seamless-m4t-large-v2 at full width: prefill and serving -------
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build as build_model
    from repro_torch.models import count_params, encdec
    from repro_torch.models.attention import attention as attention_mixer
    from repro_torch.models.common import apply_norm
    from repro_torch.models.mlp import apply_mlp

    torch.cuda.empty_cache()
    s_cfg = get_arch(SEAMLESS).full()
    bundle = build_model(s_cfg)
    sgen = torch.Generator(device=dev).manual_seed(0)
    t = time.perf_counter()
    sparams = bundle.init(sgen)
    torch.cuda.synchronize()
    print(f"[seamless] {s_cfg.name} full(): {s_cfg.n_encoder_layers}+{s_cfg.n_layers} layers, "
          f"d_model {s_cfg.d_model}, {s_cfg.n_heads} heads of {s_cfg.hd}, d_ff {s_cfg.d_ff}, "
          f"vocab {s_cfg.vocab_size}, {s_cfg.dtype}: {count_params(sparams):,} params drawn in "
          f"{time.perf_counter() - t:.2f} s")
    frames = torch.randn((PF_B, s_cfg.frontend_tokens, s_cfg.d_model), generator=sgen, device=dev)
    tokens = torch.randint(0, s_cfg.vocab_size, (PF_B, PF_T), generator=sgen, device=dev)
    batch = {"prefix": frames, "tokens": tokens}

    def counted(label, fn, expect):
        return run_counted(wrappers, label, fn, expect)

    def cut(params, depth):
        return {k: (tree.map(lambda x: x[:depth], v) if k in ("encoder", "decoder") else v)
                for k, v in params.items()}

    n_dec = s_cfg.n_layers
    with torch.inference_mode():
        prefill = build_step(bundle, "prefill")
        pf_s = []
        for i in range(2):  # the first call also sets up cuBLAS
            torch.cuda.reset_peak_memory_stats()
            logits, secs, launched = counted("seamless prefill", lambda: prefill(sparams, batch),
                                             {"flash_attention": n_dec})
            pf_s.append(secs)
        flash_launches = launched["flash_attention"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(tuple(logits.shape) == (PF_B, s_cfg.vocab_size) and logits.dtype == s_cfg.tdtype
              and bool(torch.isfinite(logits.float()).all()),
              f"seamless prefill logits {tuple(logits.shape)} {logits.dtype}: not finite "
              f"{s_cfg.dtype} ({PF_B}, {s_cfg.vocab_size})")
        plain, plain_s, _ = counted("seamless plain prefill", lambda: bundle.forward(
            sparams, batch, use_flash=False)[:, -1, :].contiguous(), {})
        deep_rel = rel_l2(logits, plain)
        print(f"[seamless] prefill step, {PF_B} requests x ({s_cfg.frontend_tokens} frames + "
              f"{PF_T}-token prompt): {1e3 * pf_s[1]:.1f} ms (first call {1e3 * pf_s[0]:.1f} ms), "
              f"flash_attention launches {flash_launches}, peak memory {peak_gb:.2f} GB "
              f"(torch.cuda.max_memory_allocated); plain path (chunked causal) "
              f"{1e3 * plain_s:.1f} ms; last logits finite, flash vs plain relative L2 at all "
              f"{n_dec} layers {deep_rel:.3e} (chaotic in depth, see PREFILL_TOL) [{card}]")
        del logits, plain
        # the comparison at a depth cut, bf16 and f32
        for dtype in (torch.bfloat16, torch.float32):
            cfg_d = s_cfg.replace(dtype=str(dtype)[6:], n_layers=CMP_DEPTH,
                                  n_encoder_layers=CMP_DEPTH)
            b_d = build_model(cfg_d)
            p_d = tree.map(lambda x: x.to(dtype), cut(sparams, CMP_DEPTH))
            lf, _, _ = counted("depth-cut prefill", lambda: build_step(b_d, "prefill")(p_d, batch),
                               {"flash_attention": CMP_DEPTH})
            lp, _, _ = counted("depth-cut plain prefill", lambda: b_d.forward(
                p_d, batch, use_flash=False)[:, -1, :].contiguous(), {})
            r = rel_l2(lf, lp)
            check(r <= PREFILL_TOL[dtype], f"seamless prefill at depth {CMP_DEPTH}, "
                  f"{dtype}: flash vs plain relative L2 {r}")
            print(f"[seamless] prefill at depth {CMP_DEPTH} (full width, same shapes), "
                  f"{str(dtype)[6:]}: flash vs plain last logits relative L2 {r:.3e} "
                  f"(tol {PREFILL_TOL[dtype]}), max abs "
                  f"{float((lf.float() - lp.float()).abs().max()):.3e}")
            del lf, lp, p_d
        torch.cuda.empty_cache()

        # the serving path of python -m repro_torch.launch.serve
        res, serve_s, launched = counted("seamless serve", lambda: serve(
            SEAMLESS, batch=SV_B, prompt_len=SV_P, gen=SV_G, device=dev, params=sparams,
            log=lambda line: print(f"[serve] {line}")), {"flash_attention": n_dec})
        check(tuple(res.tokens.shape) == (SV_B, SV_G) and int(res.tokens.min()) >= 0
              and int(res.tokens.max()) < s_cfg.vocab_size, f"served tokens {res.tokens.shape}")
        check(bool(torch.isfinite(res.prefill_logits.float()).all())
              and bool(torch.isfinite(res.replay_logits.float()).all()), "serve logits not finite")
        print(f"[serve] {SV_B} requests, {SV_P}-token prompt replayed through the serve step, "
              f"{SV_G} greedy tokens: prefill {1e3 * res.prefill_s:.2f} ms, replay "
              f"{1e3 * res.replay_s:.2f} ms, decode {res.decode_ms_per_step:.3f} ms/step, "
              f"{res.tokens_per_s:.1f} tok/s, flash launches {launched}; prefill vs replay last "
              f"logits relative L2 at all {n_dec} layers "
              f"{rel_l2(res.prefill_logits, res.replay_logits):.3e} [{card}]")
        # decode consistency (tests/test_decode_consistency.py's check) at
        # the depth cut: the prefill step's last logits against the last
        # replayed serve step on the same prompt
        for dtype, depth in ((torch.bfloat16, 1), (torch.float32, CMP_DEPTH)):
            cfg_d = s_cfg.replace(dtype=str(dtype)[6:], n_layers=depth, n_encoder_layers=depth)
            b_d = build_model(cfg_d)
            p_d = tree.map(lambda x: x.to(dtype), cut(sparams, depth))
            sv_batch = {"prefix": res.frames, "tokens": res.prompts}
            pre = build_step(b_d, "prefill")(p_d, sv_batch)
            step = build_step(b_d, "decode")
            cache = b_d.init_cache(SV_B, SV_P, s_cfg.frontend_tokens, device=dev)
            cache["memory"] = encdec.encode(cfg_d, p_d, res.frames)
            for t_ in range(SV_P):
                last, cache = step(p_d, cache, res.prompts[:, t_:t_ + 1], t_)
            r = rel_l2(last, pre)
            check(r <= PREFILL_TOL[dtype], f"decode replay vs prefill at depth {depth}, "
                  f"{dtype}: relative L2 {r}")
            print(f"[serve] decode consistency at depth {depth} (full width), {str(dtype)[6:]}: "
                  f"replayed serve step vs prefill step last logits relative L2 {r:.3e} "
                  f"(tol {PREFILL_TOL[dtype]})")
            del cache, p_d

        # where a prefill and a decode step spend their time
        sv_prefill, sv_step = build_step(bundle, "prefill"), build_step(bundle, "decode")
        sv_cache = bundle.init_cache(SV_B, SV_P + SV_G, s_cfg.frontend_tokens, device=dev)
        sv_cache["memory"] = encdec.encode(s_cfg, sparams, res.frames)
        tok = res.prompts[:, :1]
        for label, fn in (
                (f"one prefill step ({PF_B} x {PF_T} tokens)", lambda: prefill(sparams, batch)),
                (f"{SV_PROF} serve steps ({SV_B} requests)", lambda: [
                    sv_step(sparams, sv_cache, tok, t_) for t_ in range(SV_PROF)])):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            print(f"[profile] {label} under torch.profiler: wall {wall_ms:.1f} ms, device busy "
                  f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%), "
                  f"{sum(e.count for e in kernels)} kernels [{card}]")
            for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
                print(f"[profile] top device: {e.key[:70]:70s} calls={e.count:6d} "
                      f"ms={e.self_device_time_total / 1e3:9.2f}")
        del sv_cache
    torch.cuda.empty_cache()

    # -- 8. kernel 10 at the prefill shape ----------------------------------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    BH, T_, D_ = PF_B * s_cfg.n_heads, PF_T, s_cfg.hd
    q, k, v = (torch.randn(BH, T_, D_, generator=g).to(torch.bfloat16).to(dev) for _ in range(3))
    jgen_fl = torch.Generator(device=dev).manual_seed(1)
    before = fl.flash_attention_cuda.launches
    got = fl.flash_attention_cuda(q, k, v)
    flash_check(got, fl.flash_attention_plain(q, k, v), fl.flash_attention_cuda.launches - before,
                f"bf16 (BH, T, D)=({BH}, {T_}, {D_}), the prefill's shape")
    del got
    q4, k4, v4 = (x.view(PF_B, s_cfg.n_heads, T_, D_) for x in (q, k, v))
    fl_flops = 4 * BH * D_ * T_ * (T_ + 1) // 2
    fl_bytes = 4 * BH * T_ * D_ * 2
    fl_times = dict(
        ms=median_ms(lambda: fl.flash_attention_cuda(q, k, v), flush, 20),
        plain_ms=median_ms(lambda: fl.flash_attention_plain(q, k, v), flush, 5),
        library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), flush, 50),
        bound_ms=bound_ms(fl_bytes, fl_flops, BF16_FLOPS))
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:64",
                     launches=flash_launches, max_abs_err=max_err["flash_attention"],
                     bound_by="operations" if fl_flops / BF16_FLOPS > fl_bytes / HBM_BYTES_PER_S
                     else "bytes", **fl_times))
    print(f"[time] flash_attention (one launch, BH={BH} T={T_} D={D_} bf16, causal; "
          f"{fl_flops / 1e9:.1f} GFLOP, {fl_bytes / 1e6:.1f} MB): kernel {fl_times['ms']:.4f} ms "
          f"({fl_flops / fl_times['ms'] / 1e9:.1f} TFLOP/s), bound {fl_times['bound_ms']:.4f} ms "
          f"(operations at {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16), plain {fl_times['plain_ms']:.4f} "
          f"ms, library (scaled_dot_product_attention, is_causal) {fl_times['library_ms']:.4f} ms "
          f"[{card}]")

    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()

    # kernel 10 at jamba's prefill shape: 64 query heads over 8 kv heads,
    # D=128, q, k, v the strided (B, T, heads, D) slices of one fused QKV
    # tensor, through the entry point the attention mixer calls.  The kernel
    # reads them in place: the call allocates its output and nothing else
    # (no k/v repeat, no transpose copy).  Held to the plain version on one
    # kv group (its 8 query heads): the plain score tensor of all 64 heads
    # would be 17 GB.
    ja = get_arch(JAMBA).full()
    JH, JKV, JD = ja.n_heads, ja.n_kv_heads, ja.hd
    qkv = torch.randn(JB_B, JB_T, JH + 2 * JKV, JD, generator=jgen_fl, device=dev,
                      dtype=torch.bfloat16)
    jq, jk, jv = qkv[:, :, :JH], qkv[:, :, JH:JH + JKV], qkv[:, :, JH + JKV:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = fl.flash_attention_cuda.launches
    got = ops.flash_attention(jq, jk, jv)
    launched = fl.flash_attention_cuda.launches - before
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    out_bytes = got.numel() * got.element_size()
    check(extra <= out_bytes, f"ops.flash_attention at jamba's shape allocated {extra} bytes "
          f"beyond its inputs, more than its {out_bytes}-byte output")
    G = JH // JKV
    for kv_ in (0, JKV - 1):  # the first and the last kv group
        hs = slice(kv_ * G, (kv_ + 1) * G)
        flash_check(heads_first(got[:, :, hs]), fl.flash_attention_plain(
            heads_first(jq[:, :, hs]), heads_first(jk[:, :, kv_:kv_ + 1].expand(-1, -1, G, -1)),
            heads_first(jv[:, :, kv_:kv_ + 1].expand(-1, -1, G, -1))), launched,
            f"bf16 jamba (B, T, H, KV, D)=({JB_B}, {JB_T}, {JH}, {JKV}, {JD}) strided views, "
            f"query heads {hs.start}-{hs.stop - 1} against the plain version on kv head {kv_}")
    del got
    jf_flops = 4 * JB_B * JH * JD * JB_T * (JB_T + 1) // 2
    jf_bytes = 2 * (2 * JH + 2 * JKV) * JB_B * JB_T * JD
    jf_ms = median_ms(lambda: ops.flash_attention(jq, jk, jv), flush, 10)
    jf_sdpa_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        jq.transpose(1, 2), jk.transpose(1, 2), jv.transpose(1, 2), is_causal=True,
        enable_gqa=True), flush, 10)
    jf_bound = bound_ms(jf_bytes, jf_flops, BF16_FLOPS)
    print(f"[time] flash_attention at jamba's prefill shape (one launch through "
          f"ops.flash_attention, B={JB_B} T={JB_T} H={JH} KV={JKV} D={JD} bf16, strided views of "
          f"one fused QKV tensor, {extra / 1e6:.1f} MB allocated for a {out_bytes / 1e6:.1f} MB "
          f"output; {jf_flops / 1e12:.3f} TFLOP, {jf_bytes / 1e6:.1f} MB): kernel {jf_ms:.4f} ms "
          f"({jf_flops / jf_ms / 1e9:.1f} TFLOP/s), bound {jf_bound:.4f} ms (operations at "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16), library (scaled_dot_product_attention, "
          f"is_causal, enable_gqa) {jf_sdpa_ms:.4f} ms [{card}]")
    del qkv, jq, jk, jv, sparams, bundle, res, batch, frames, tokens
    torch.cuda.empty_cache()

    # -- 9. jamba-1.5-large-398b at full width, one period: prefill, serving -
    from repro_torch.models import hybrid, mamba

    j_cfg = get_arch(JAMBA).full().replace(n_layers=8, moe_every=0)
    j_bundle = build_model(j_cfg)
    period = j_cfg.attn_every
    n_mamba = period - 1
    jgen = torch.Generator(device=dev).manual_seed(0)
    t = time.perf_counter()
    jparams = j_bundle.init(jgen)
    torch.cuda.synchronize()
    n_params = count_params(jparams)
    print(f"[jamba] {j_cfg.name} full() at one period: {j_cfg.n_layers} layers (1 attention + "
          f"{n_mamba} Mamba, dense SwiGLU MLPs), d_model {j_cfg.d_model}, {j_cfg.n_heads} heads "
          f"of {j_cfg.hd} over {j_cfg.n_kv_heads} kv heads, d_ff {j_cfg.d_ff}, vocab "
          f"{j_cfg.vocab_size}, d_inner {j_cfg.d_inner} as {j_cfg.n_ssm_heads} SSM heads of "
          f"{j_cfg.d_inner // j_cfg.n_ssm_heads}, d_state {j_cfg.ssm_d_state}, chunk "
          f"{j_cfg.ssm_chunk}, {j_cfg.dtype}: {n_params:,} params "
          f"({2 * n_params / 1e9:.2f} GB) drawn in {time.perf_counter() - t:.2f} s")
    check((JB_B * j_cfg.n_ssm_heads, JB_T, j_cfg.ssm_d_state,
           j_cfg.d_inner // j_cfg.n_ssm_heads) == SSD_PREFILL_SHAPE,
          f"the prefill's SSD shape is not {SSD_PREFILL_SHAPE}")
    j_tokens = torch.randint(0, j_cfg.vocab_size, (JB_B, JB_T), generator=jgen, device=dev)
    j_batch = {"tokens": j_tokens}
    j_expect = {"flash_attention": 1, "ssd_scan": n_mamba}
    with torch.inference_mode():
        j_prefill = build_step(j_bundle, "prefill")
        jpf_s = []
        for i in range(3):  # the first call also sets up cuBLAS
            torch.cuda.reset_peak_memory_stats()
            j_logits, secs, launched = counted("jamba prefill",
                                               lambda: j_prefill(jparams, j_batch), j_expect)
            jpf_s.append(secs)
        j_launches = launched
        j_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(tuple(j_logits.shape) == (JB_B, j_cfg.vocab_size) and j_logits.dtype == j_cfg.tdtype
              and bool(torch.isfinite(j_logits.float()).all()),
              f"jamba prefill logits {tuple(j_logits.shape)} {j_logits.dtype}: not finite "
              f"{j_cfg.dtype} ({JB_B}, {j_cfg.vocab_size})")
        j_plain, j_plain_s, _ = counted("jamba plain prefill", lambda: j_bundle.forward(
            jparams, j_batch, use_flash=False)[:, -1, :].contiguous(), {})
        print(f"[jamba] prefill step, {JB_B} requests x {JB_T} tokens: "
              f"{1e3 * statistics.median(jpf_s[1:]):.1f} ms (median of calls 2-3: "
              f"{[round(1e3 * x, 1) for x in jpf_s[1:]]}, first call {1e3 * jpf_s[0]:.1f} ms), "
              f"launches {j_launches}, peak memory {j_peak_gb:.2f} GB "
              f"(torch.cuda.max_memory_allocated); plain path (chunked causal attention, "
              f"ssd_scan_plain) {1e3 * j_plain_s:.1f} ms, no launches; last logits finite, kernel "
              f"vs plain relative L2 {rel_l2(j_logits, j_plain):.3e} [{card}]")
        del j_logits, j_plain

        # every mixer of the period at full width, through its kernel and
        # through its plain version on the same normalised input; the residual
        # stream goes on with the kernel's output
        pp = {k_: tree.map(lambda x: x[0], v_) for k_, v_ in jparams["periods"].items()}
        x = jparams["embed"][j_tokens]
        for j in range(period):
            mix, key = pp["mixers"][f"l{j}"], f"l{j}"
            xn = apply_norm(j_cfg, pp["norms1"][key], x)
            if j == 0:
                hk, _, got = counted("attention mixer", lambda: attention_mixer(
                    j_cfg, mix, xn, use_flash=True), {"flash_attention": 1})
                hp = attention_mixer(j_cfg, mix, xn, use_flash=False)
                what = "attention (flash_attention vs chunked causal attention)"
            else:
                (hk, _), _, got = counted("mamba mixer", lambda: mamba.mamba_forward(
                    j_cfg, mix, xn), {"ssd_scan": 1})
                hp, _ = mamba.mamba_forward(j_cfg, mix, xn, ssd_kernel=False)
                what = "Mamba (ssd_scan vs ssd_scan_plain)"
            r = rel_l2(hk, hp)
            check(r <= PREFILL_TOL[torch.bfloat16], f"jamba layer {j} mixer: kernel vs plain "
                  f"relative L2 {r}")
            print(f"[jamba] layer {j} {what}, bf16 {JB_B} x {JB_T}: relative L2 {r:.3e} "
                  f"(tol {PREFILL_TOL[torch.bfloat16]}), max abs "
                  f"{float((hk.float() - hp.float()).abs().max()):.3e}, launches {got}")
            x = x + hk
            x = x + apply_mlp(j_cfg, pp["ffns"][key], apply_norm(j_cfg, pp["norms2"][key], x))
            del hk, hp, xn
        del x, pp

        # the serving path of python -m repro_torch.launch.serve, bf16
        j_res, _, sv_launched = counted("jamba serve", lambda: serve(
            cfg=j_cfg, batch=JB_B, prompt_len=JB_SV_P, gen=JB_SV_G, device=dev, params=jparams,
            log=lambda line: print(f"[serve] {line}")), j_expect)
        check(tuple(j_res.tokens.shape) == (JB_B, JB_SV_G) and int(j_res.tokens.min()) >= 0
              and int(j_res.tokens.max()) < j_cfg.vocab_size and j_res.frames is None,
              f"jamba served tokens {tuple(j_res.tokens.shape)}")
        check(bool(torch.isfinite(j_res.prefill_logits.float()).all())
              and bool(torch.isfinite(j_res.replay_logits.float()).all()),
              "jamba serve logits not finite")
        print(f"[serve] jamba {JB_B} requests, {JB_SV_P}-token prompt replayed through the serve "
              f"step, {JB_SV_G} greedy tokens: prefill {1e3 * j_res.prefill_s:.2f} ms, replay "
              f"{1e3 * j_res.replay_s:.2f} ms, decode {j_res.decode_ms_per_step:.3f} ms/step, "
              f"{j_res.tokens_per_s:.1f} tok/s, launches {sv_launched}; bf16 prefill vs replay "
              f"last logits relative L2 {rel_l2(j_res.prefill_logits, j_res.replay_logits):.3e} "
              f"[{card}]")

        # where a prefill and a decode step spend their time
        j_cache = j_bundle.init_cache(JB_B, JB_SV_P + JB_SV_G, device=dev)
        j_step = build_step(j_bundle, "decode")
        tok = j_res.prompts[:, :1]
        for label, fn in (
                (f"jamba prefill step ({JB_B} x {JB_T} tokens)",
                 lambda: j_prefill(jparams, j_batch)),
                (f"jamba {JB_SV_G} serve steps ({JB_B} requests)",
                 lambda: [j_step(jparams, j_cache, tok, t_) for t_ in range(JB_SV_G)])):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            print(f"[profile] {label} under torch.profiler: wall {wall_ms:.1f} ms, device busy "
                  f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%), "
                  f"{sum(e.count for e in kernels)} kernels [{card}]")
            for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
                print(f"[profile] top device: {e.key[:70]:70s} calls={e.count:6d} "
                      f"ms={e.self_device_time_total / 1e3:9.2f}")
            for name in ("flash_tc_kernel", "ssd_scan_tc_kernel"):  # kernels 10 and 11
                hits = [e for e in kernels if name in e.key]
                if hits:
                    print(f"[profile] {name}: calls={sum(e.count for e in hits)} ms="
                          f"{sum(e.self_device_time_total for e in hits) / 1e3:.2f}")
        del j_cache

        # the whole period in f32 (1 x 1024: the f32 params take 35.6 GB),
        # kernel path against plain path; then the served prompt's prefill
        # against its replay through the serve step, in f32
        f_cfg = j_cfg.replace(dtype="float32")
        f_bundle = build_model(f_cfg)
        fparams = tree.map(lambda x_: x_.float(), jparams)
        f_batch = {"tokens": j_tokens[:1, :JB_F32_T]}
        fk, _, got = counted("jamba f32 prefill", lambda: build_step(f_bundle, "prefill")(
            fparams, f_batch), j_expect)
        fpl, _, _ = counted("jamba f32 plain prefill", lambda: f_bundle.forward(
            fparams, f_batch, use_flash=False)[:, -1, :].contiguous(), {})
        r = rel_l2(fk, fpl)
        check(r <= PREFILL_TOL[torch.float32], f"jamba f32 period, kernel vs plain: {r}")
        print(f"[jamba] the whole period in f32, 1 x {JB_F32_T} tokens: kernel vs plain path "
              f"last logits relative L2 {r:.3e} (tol {PREFILL_TOL[torch.float32]}), max abs "
              f"{float((fk - fpl).abs().max()):.3e}, launches {got}")
        f_res, _, _ = counted("jamba f32 serve", lambda: serve(
            cfg=f_cfg, batch=JB_B, prompt_len=JB_SV_P, gen=1, device=dev, params=fparams,
            log=None), j_expect)
        check(torch.equal(f_res.prompts, j_res.prompts), "the f32 serve drew other prompts")
        r = rel_l2(f_res.replay_logits, f_res.prefill_logits)
        check(r <= PREFILL_TOL[torch.float32], f"jamba f32 decode replay vs prefill: {r}")
        print(f"[serve] jamba decode consistency in f32 (full width, one period): the "
              f"{JB_SV_P}-token prompt replayed through the serve step (ssd_step's recursion, the "
              f"KV cache) vs the prefill step (ssd_scan from a zero state, flash_attention) last "
              f"logits relative L2 {r:.3e} (tol {PREFILL_TOL[torch.float32]})")
        del fparams, fk, fpl, f_res
    torch.cuda.empty_cache()

    # -- 10. kernel 11 at the prefill shape -----------------------------------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    BH, T_, Dk_, Dv_ = SSD_PREFILL_SHAPE
    Q_ = j_cfg.ssm_chunk
    q, k = (torch.randn(BH, T_, Dk_, generator=jgen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    v = torch.randn(BH, T_, Dv_, generator=jgen, device=dev, dtype=torch.bfloat16)
    logd = -torch.rand(BH, T_, generator=jgen, device=dev)
    # each input read once and the output written once; the products of the
    # live (s <= t) pairs, the inter-chunk term and the state update
    ssd_nbytes = ssd_bytes(BH, T_, Dk_, Dv_)
    ssd_flops = BH * (T_ // Q_) * (Q_ * (Q_ + 1) * (Dk_ + Dv_) + 4 * Q_ * Dk_ * Dv_)
    ssd_times = dict(
        ms=median_ms(lambda: ssd.ssd_scan_cuda(q, k, v, logd, chunk=Q_), flush, SSD_REPS),
        plain_ms=median_ms(lambda: ssd.ssd_scan_plain(q, k, v, logd, chunk=Q_), flush, 5),
        library_ms=None,
        bound_ms=bound_ms(ssd_nbytes, ssd_flops, BF16_FLOPS))
    # the same work on the views the Mamba mixer passes (q, k broadcast over
    # the heads, v and y in (B, T, H, P) storage)
    H_ = j_cfg.n_ssm_heads
    qb, kb, vb, lb = mamba_views(jgen, dev, JB_B, H_, T_, Dk_, Dv_)
    views_ms = median_ms(lambda: ssd.ssd_scan_cuda(qb, kb, vb, lb, chunk=Q_), flush, SSD_REPS)
    got = ssd.ssd_scan_cuda(qb, kb, vb, lb, chunk=Q_)
    want = ssd.ssd_scan_plain(*(x_.reshape(BH, T_, x_.shape[-1]) for x_ in (qb, kb, vb)),
                              lb.reshape(BH, T_), chunk=Q_)
    e = (got.reshape(BH, T_, Dv_).float() - want.float()).abs()
    tol = SSD_TOL[torch.bfloat16]
    check(bool(torch.all(e <= tol + tol * want.float().abs())),
          f"ssd_scan on the Mamba views at the prefill shape: disagrees with its plain version "
          f"by {float(e.max())}")
    max_err["ssd_scan"] = max(max_err["ssd_scan"], float(e.max()))
    blk = ssd_held(got.reshape(BH, T_, Dv_), want, Q_, "on the Mamba views at the prefill shape")
    print(f"[kernels] ssd_scan bf16 on the Mamba views at the prefill shape "
          f"max_abs_err={float(e.max()):.3e} (atol = rtol = {tol}), {blk}")
    del got, want, e
    rows.append(dict(name="ssd_scan", route="cuda",
                     source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                     replaces="src/repro/kernels/ssd_scan.py:73",
                     launches=j_launches["ssd_scan"], max_abs_err=max_err["ssd_scan"],
                     bound_by="operations" if ssd_flops / BF16_FLOPS > ssd_nbytes / HBM_BYTES_PER_S
                     else "bytes", views_ms=views_ms, **ssd_times))
    print(f"[time] ssd_scan (one launch, (BH, T, Dk, Dv)={SSD_PREFILL_SHAPE} chunk {Q_} bf16; "
          f"{ssd_flops / 1e9:.1f} GFLOP, {ssd_nbytes / 1e9:.3f} GB): kernel {ssd_times['ms']:.4f} "
          f"ms ({ssd_nbytes / ssd_times['ms'] / 1e9:.3f} TB/s), bound {ssd_times['bound_ms']:.4f} "
          f"ms (bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), plain {ssd_times['plain_ms']:.4f} "
          f"ms, library null: no single PyTorch call computes the SSD recurrence; on the Mamba "
          f"mixer's views (q, k broadcast over {H_} heads, v and y in (B, T, H, P) storage) "
          f"{views_ms:.4f} ms ({ssd_nbytes / views_ms / 1e9:.3f} TB/s) [{card}]")

    # -- 11. the rest of the model zoo, served ---------------------------------
    del jparams
    torch.cuda.empty_cache()
    serve_zoo(dev, card, wrappers)

    # -- 12. training the zoo through the launcher -----------------------------
    torch.cuda.empty_cache()
    train_zoo(dev, card, wrappers, rows, flush)

    # -- 13. the one-card dry run and the examples -----------------------------
    torch.cuda.empty_cache()
    dry_run_and_examples(dev, card, wrappers)

    print(f"[smoke] the script's wall, the build included: {time.perf_counter() - t_main:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def serve_zoo(dev, card, wrappers):
    """Phase 11: the dense, MoE, RWKV6 and VLM language models and jamba
    with its experts, served at full width (see ZOO, JE_T, ZOO_CMP_*)."""
    from repro_torch import tree
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build as build_model
    from repro_torch.models import count_params

    t11 = time.perf_counter()

    def counted(label, fn, expect):
        return run_counted(wrappers, label, fn, expect)

    def finite_logits(label, logits, cfg, rows):
        check(tuple(logits.shape) == (rows, cfg.vocab_size) and logits.dtype == cfg.tdtype
              and bool(torch.isfinite(logits.float()).all()),
              f"{label}: logits {tuple(logits.shape)} {logits.dtype}, expected finite "
              f"{cfg.dtype} ({rows}, {cfg.vocab_size})")

    def consistency(label, cfg, params, expect):
        """The f32 prefill step against the same prompt replayed through the
        serve step, with the MoE layers' dropped assignments counted."""
        P = ZOO_CMP_P.get(cfg.name, ZOO_CMP_P_DEFAULT)
        with moe_drops() as drops:
            res, _, _ = counted(f"{label} f32 serve", lambda: serve(
                cfg=cfg, batch=ZOO_B, prompt_len=P, gen=1, device=dev, params=params,
                log=None), expect)
        pre, rep = res.prefill_logits, res.replay_logits
        err = (rep - pre).abs()
        ok = bool(torch.all(err <= ZOO_CMP_TOL + ZOO_CMP_TOL * pre.abs()))
        moe_note = ""
        if cfg.n_experts:
            moe_note = (f"; dropped assignments {sum(drops)} over {len(drops)} MoE calls "
                        f"(the prefill's and {P} serve steps')")
            check(sum(drops) == 0, f"{label}: {sum(drops)} assignments dropped where the "
                  "prefill is compared with the replay")
        check(ok, f"{label}: f32 prefill vs replay at depth {ZOO_CMP_DEPTH}: max abs "
              f"{float(err.max())}")
        print(f"[zoo] {label} decode consistency in f32 at depth {ZOO_CMP_DEPTH} (full width), "
              f"{ZOO_B} x {P}-token prompt: replayed serve step vs prefill step last logits "
              f"max abs {float(err.max()):.3e}, relative L2 {rel_l2(rep, pre):.3e} "
              f"(atol = rtol = {ZOO_CMP_TOL}){moe_note} [{card}]")

    with torch.inference_mode():
        for arch in ZOO:
            cfg = get_arch(arch).full()
            bundle = build_model(cfg)
            gen = torch.Generator(device=dev).manual_seed(0)
            t = time.perf_counter()
            params = bundle.init(gen)
            torch.cuda.synchronize()
            n_params = count_params(params)
            print(f"[zoo] {arch} full() [{cfg.arch_type}]: {cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads} kv "
                  f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
                  f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}, "
                  f"{cfg.dtype}: {n_params:,} params ({2 * n_params / 1e9:.2f} GB) drawn in "
                  f"{time.perf_counter() - t:.2f} s [{card}]")
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (ZOO_B, ZOO_T), generator=gen,
                                             device=dev)}
            if cfg.arch_type == "vlm":
                batch["prefix"] = torch.randn((ZOO_B, cfg.frontend_tokens, cfg.d_model),
                                              generator=gen, device=dev)
            prefill = build_step(bundle, "prefill")
            pf_s = []
            for _ in range(2):  # the first call also sets up cuBLAS
                held_gb = torch.cuda.memory_allocated() / 1e9
                torch.cuda.reset_peak_memory_stats()
                logits, secs, _ = counted(f"{arch} prefill", lambda: prefill(params, batch), {})
                pf_s.append(secs)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            finite_logits(f"{arch} prefill", logits, cfg, ZOO_B)
            drop_note = ""
            if cfg.n_experts:
                with moe_drops() as drops:
                    prefill(params, batch)
                drop_note = (f", dropped assignments {sum(drops)} of "
                             f"{len(drops) * ZOO_B * ZOO_T * cfg.top_k} over {len(drops)} layers")
            prefix = (f" + {cfg.frontend_tokens} patches" if "prefix" in batch else "")
            print(f"[zoo] {arch} prefill step, {ZOO_B} requests x {ZOO_T} tokens{prefix}: "
                  f"{1e3 * pf_s[1]:.1f} ms (first call {1e3 * pf_s[0]:.1f} ms), no kernel "
                  f"launched, peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated; "
                  f"{held_gb:.2f} GB allocated before the call){drop_note} [{card}]")
            del logits
            res, _, _ = counted(f"{arch} serve", lambda: serve(
                cfg=cfg, batch=ZOO_B, prompt_len=ZOO_SV_P, gen=ZOO_SV_G, device=dev,
                params=params, log=lambda line: print(f"[serve] {line} [{card}]")), {})
            check(tuple(res.tokens.shape) == (ZOO_B, ZOO_SV_G) and int(res.tokens.min()) >= 0
                  and int(res.tokens.max()) < cfg.vocab_size, f"{arch} served tokens "
                  f"{tuple(res.tokens.shape)}")
            finite_logits(f"{arch} serve prefill", res.prefill_logits, cfg, ZOO_B)
            finite_logits(f"{arch} serve replay", res.replay_logits, cfg, ZOO_B)
            print(f"[zoo] {arch} serving {ZOO_B} requests, {ZOO_SV_P}-token prompt replayed "
                  f"through the serve step, {ZOO_SV_G} greedy tokens: prefill "
                  f"{1e3 * res.prefill_s:.2f} ms, replay {1e3 * res.replay_s:.2f} ms, decode "
                  f"{res.decode_ms_per_step:.3f} ms/step, {res.tokens_per_s:.1f} tok/s [{card}]")
            # the f32 check at a depth cut, on the same params; a VLM without
            # its prefix (its decode step has none)
            cut = cfg.replace(n_layers=ZOO_CMP_DEPTH, dtype="float32",
                              frontend_tokens=0 if cfg.arch_type == "vlm" else cfg.frontend_tokens)
            p32 = {k: tree.map(lambda x: (x[:ZOO_CMP_DEPTH] if k == "layers" else x).float(), v)
                   for k, v in params.items()}
            del params, res
            consistency(arch, cut, p32, {})
            del p32, bundle
            torch.cuda.empty_cache()

        # jamba with its experts: one period, 4 experts
        je_cfg = get_arch(JAMBA).full().replace(n_layers=8, n_experts=4)
        je_bundle = build_model(je_cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        t = time.perf_counter()
        jparams = je_bundle.init(gen)
        torch.cuda.synchronize()
        n_params = count_params(jparams)
        print(f"[zoo] {JAMBA} full() at one period with {je_cfg.n_experts} experts (top-"
              f"{je_cfg.top_k}, a MoE MLP at positions 1, 3, 5, 7): {n_params:,} params "
              f"({2 * n_params / 1e9:.2f} GB) drawn in {time.perf_counter() - t:.2f} s [{card}]")
        expect = {"flash_attention": 1, "ssd_scan": je_cfg.attn_every - 1}
        tokens = torch.randint(0, je_cfg.vocab_size, (1, JE_T), generator=gen, device=dev)
        prefill = build_step(je_bundle, "prefill")
        pf_s = []
        for _ in range(2):
            held_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            logits, secs, launched = counted("jamba with experts prefill", lambda: prefill(
                jparams, {"tokens": tokens}), expect)
            pf_s.append(secs)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finite_logits("jamba with experts prefill", logits, je_cfg, 1)
        with moe_drops() as drops:
            prefill(jparams, {"tokens": tokens})
        print(f"[zoo] jamba with experts prefill step, 1 request x {JE_T} tokens: "
              f"{1e3 * pf_s[1]:.1f} ms (first call {1e3 * pf_s[0]:.1f} ms), launches "
              f"{launched}, peak memory {peak_gb:.2f} GB ({held_gb:.2f} GB allocated before the "
              f"call), dropped assignments {sum(drops)} of "
              f"{len(drops) * JE_T * je_cfg.top_k} over {len(drops)} MoE layers [{card}]")
        step = build_step(je_bundle, "decode")
        cache = je_bundle.init_cache(1, JE_STEPS, device=dev)
        step_s = []
        for t_ in range(JE_STEPS):
            (last, cache), secs, _ = counted("jamba with experts decode step", lambda: step(
                jparams, cache, tokens[:, t_:t_ + 1], t_), {})
            step_s.append(secs)
        finite_logits("jamba with experts decode", last, je_cfg, 1)
        print(f"[zoo] jamba with experts, {JE_STEPS} decode steps (1 request): "
              f"{1e3 * statistics.median(step_s[1:]):.3f} ms/step (median of steps 2-"
              f"{JE_STEPS}; first {1e3 * step_s[0]:.3f} ms), "
              f"{1 / statistics.median(step_s[1:]):.1f} tok/s [{card}]")
        del logits, last, cache
        # the f32 check on the period's first two layers (attention + dense
        # MLP, Mamba + MoE): a period of two with the same pattern
        cut = je_cfg.replace(n_layers=ZOO_CMP_DEPTH, attn_every=ZOO_CMP_DEPTH, dtype="float32")
        p32 = {k: (tree.map(lambda x: x.float(), v) if k != "periods" else
                   {part: {f"l{j}": tree.map(lambda x: x.float(), v[part][f"l{j}"])
                           for j in range(ZOO_CMP_DEPTH)} for part in v})
               for k, v in jparams.items()}
        del jparams
        consistency("jamba with experts", cut, p32, {"flash_attention": 1, "ssd_scan": 1})
        del p32, je_bundle
    torch.cuda.empty_cache()
    print(f"[zoo] phase 11 wall {time.perf_counter() - t11:.1f} s [{card}]")


def train_zoo(dev, card, wrappers, rows, flush):
    """Phase 12: the zoo trained through ``repro_torch.launch.train`` (see
    TR_*); kernels 1 and 2 timed at qwen3's (8, d), their rows of the
    ``kernels`` line given the ``train_*`` figures."""
    from repro_torch import tree
    from repro_torch.configs.base import CLI_ALIASES, get_arch
    from repro_torch.core import flatten
    from repro_torch.kernels import fused_aggregate as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import build as build_model
    from repro_torch.models import count_params

    t12 = time.perf_counter()
    cfg = get_arch(TR_ARCH).full()
    init = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    d = count_params(init)
    sizes = [math.prod(s_) for s_ in flatten.flat_spec(init).shapes]
    print(f"[train] {TR_ARCH} full(): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads} kv heads, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {d:,} params in {len(sizes)} leaves; the launcher's "
          f"defaults (8 clients, 4 local steps, batch 4 x 64 tokens, per_client, sgd(0.25), "
          f"PS sgd_momentum(1.0, 0.9)) [{card}]")

    def s_round(res):
        return [round(b_["seconds"] / b_["rounds"], 4) for b_ in res.blocks]

    base = ["--arch", TR_ARCH, "--rounds", str(TR_ROUNDS)]
    runs = {}
    for label, flags, expect in (
            ("collapse", [], {}),
            ("kernel", ["--fused-kernel"], {"fused_aggregate": TR_ROUNDS}),
            ("segmented", ["--fused-kernel", "--segment-d", "1"],
             {"row_stream_segments": TR_ROUNDS})):
        torch.cuda.reset_peak_memory_stats()
        res, secs, launched = run_counted(wrappers, f"train {label}", lambda: train(
            [*base, *flags], params=init), expect)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        leaves = tree.leaves(res.params)
        check(res.rounds == TR_ROUNDS and all(math.isfinite(v) for v in res.metrics["loss"])
              and all(x.device.type == dev.type and x.dtype == cfg.tdtype
                      and bool(torch.isfinite(x).all()) for x in leaves)
              and sum(x.numel() for x in leaves) == d,
              f"train {label}: {res.rounds} rounds, loss {res.metrics['loss']}")
        print(f"[train] {label} path, {TR_ROUNDS} rounds per round: loss "
              f"{res.metrics['loss']}, participation {res.metrics['participation']}, |delta| "
              f"{res.metrics['delta_norm']}, launches {launched}, wall {secs:.1f} s [{card}]")
        print(f"[train] {label} s/round {s_round(res)} [{card}]")
        print(f"[train] {label} peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated) "
              f"[{card}]")
        runs[label] = res
        res.server_state = res.agg_state = None
    for other in ("segmented", "collapse"):
        a, b_ = runs["kernel"], runs[other]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(b_.metrics["loss"],
                                                           a.metrics["loss"]))
        diff = sum(float((x.float() - y.float()).pow(2).sum())
                   for x, y in zip(tree.leaves(b_.params), tree.leaves(a.params)))
        norm = sum(float(y.float().pow(2).sum()) for y in tree.leaves(a.params))
        rel = math.sqrt(diff / norm)
        bitwise = all(torch.equal(x, y) for x, y in zip(tree.leaves(b_.params),
                                                        tree.leaves(a.params)))
        check(loss_err <= TR_LOSS_RTOL and rel <= TR_PARAM_REL
              and b_.metrics["participation"] == a.metrics["participation"],
              f"train {other} vs kernel: loss rel {loss_err}, params rel L2 {rel}")
        print(f"[train] {other} vs kernel after {TR_ROUNDS} rounds: loss max rel "
              f"{loss_err:.3e} (rtol {TR_LOSS_RTOL}), params relative L2 {rel:.3e} (tol "
              f"{TR_PARAM_REL}), bitwise {bitwise}")

    # the kernel path as one chunk: one round captured and replayed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    chunk, secs, launched = run_counted(wrappers, "train kernel chunk", lambda: train(
        ["--arch", TR_ARCH, "--rounds", str(TR_CHUNK), "--fused-kernel", "--chunk",
         str(TR_CHUNK)], params=init), {"fused_aggregate": 2})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = chunk.scan_stats
    want = {k: v[:TR_CHUNK] for k, v in runs["kernel"].metrics.items()}
    check(chunk.metrics == want, f"train chunk of {TR_CHUNK} vs per round: {chunk.metrics} != "
          f"{want}")
    check(st["captured_launches"] == {"fused_aggregate_cuda": 1} and st["replays"] == TR_CHUNK,
          f"train chunk: captured {st['captured_launches']}, replays {st['replays']}")
    print(f"[train] kernel path as one chunk of {TR_CHUNK}: every metric of both rounds bitwise "
          f"the per-round run's; launches {launched} (the warm-up round's and the capture's), "
          f"kernel 1 captured once and replayed {st['replays']} times; warm-up "
          f"{st['warmup_s']:.2f} s, capture {st['capture_s']:.2f} s, instantiate "
          f"{st['instantiate_s']:.2f} s, wall {secs:.1f} s [{card}]")
    print(f"[train] chunk peak memory {peak_gb:.2f} GB, graph pool {st['pool_bytes'] / 1e9:.2f} "
          f"GB [{card}]")
    del chunk, runs
    torch.cuda.empty_cache()

    # kernels 1 and 2 at qwen3's (8, d): the stack the kernel path aggregates
    # and its segment list
    n8 = 8
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.rand(n8, n8, generator=g, device=dev) * 0.5 + 0.1
    tu = (torch.rand(n8, generator=g, device=dev) < 0.7).float()
    td = (torch.rand(n8, n8, generator=g, device=dev) < 0.5).float()
    X = torch.randn(n8, d, generator=g, device=dev)
    w = ops.collapsed_weight_row(A, tu, td)
    mono = fa.fused_aggregate_cuda(A, tu, td, X)
    check(torch.equal(mono, fa.fused_aggregate_plain(A, tu, td, X)),
          f"fused_aggregate at (8, {d}) differs from its plain version")
    stack_bytes, out_bytes = 4 * n8 * d, 4 * d
    fa_t = dict(
        train_ms=median_ms(lambda: fa.fused_aggregate_cuda(A, tu, td, X), flush, TR_REPS),
        train_plain_ms=median_ms(lambda: fa.fused_aggregate_plain(A, tu, td, X), flush, 3),
        train_library_ms=median_ms(lambda: torch.matmul(w, X), flush, TR_REPS),
        train_bound_ms=bound_ms(4 * (2 * n8 * n8 + n8) + stack_bytes + out_bytes,
                                2 * n8 * d + 3 * n8 * n8))
    segs = [s_.contiguous() for s_ in X.split(sizes, dim=1)]
    del X
    got = fa.row_stream_segments_cuda(w, segs)
    check(torch.equal(got, mono) and torch.equal(got, fa.row_stream_segments_plain(w, segs)),
          f"row_stream_segments over qwen3's {len(segs)} segments differs from the monolithic "
          f"kernel or its plain version")
    rs_t = dict(
        train_ms=median_ms(lambda: fa.row_stream_segments_cuda(w, segs), flush, TR_REPS),
        train_plain_ms=median_ms(lambda: fa.row_stream_segments_plain(w, segs), flush, 3),
        train_library_ms=sum(median_ms(lambda: torch.matmul(w, s_), flush, 5) for s_ in segs),
        train_bound_ms=bound_ms(4 * n8 + stack_bytes + out_bytes, 2 * n8 * d))
    del segs, got, mono
    torch.cuda.empty_cache()
    for name, t_, launches, shape in (
            ("fused_aggregate", fa_t, TR_ROUNDS, f"(8, {d}) f32"),
            ("row_stream", rs_t, TR_ROUNDS, f"{len(sizes)} segments, (8, {d}) f32, one launch")):
        row = next(r_ for r_ in rows if r_["name"] == name)
        row.update(t_, train_shape=shape, train_launches=launches, train_max_abs_err=0.0)
        print(f"[train] {name} at qwen3-0.6b's {shape}: kernel {t_['train_ms']:.4f} ms "
              f"({(stack_bytes + out_bytes) / t_['train_ms'] / 1e9:.3f} TB/s), bound "
              f"{t_['train_bound_ms']:.4f} ms (bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), plain "
              f"{t_['train_plain_ms']:.4f} ms, library {t_['train_library_ms']:.4f} ms "
              f"({'w @ X' if name == 'fused_aggregate' else 'w @ seg summed'}); bitwise its "
              f"plain version; {launches} launches in {TR_ROUNDS} rounds of its path [{card}]")

    # the CLI's kill/resume at --smoke on the card, in its own processes,
    # while this one trains every arch id at --smoke for TR_SMOKE_ROUNDS rounds
    t = time.perf_counter()
    kill_resume = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "torch_kill_resume_smoke.py"), "--rounds",
         str(TR_KILL_ROUNDS), "--chunk", str(TR_KILL_CHUNK)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        for arch in sorted(CLI_ALIASES):
            res, secs, _ = run_counted(wrappers, f"train {arch} smoke", lambda: train(
                ["--arch", arch, "--smoke", "--rounds", str(TR_SMOKE_ROUNDS)]), {})
            check(res.rounds == TR_SMOKE_ROUNDS
                  and all(math.isfinite(v) for v in res.metrics["loss"] + res.metrics["delta_norm"])
                  and all(x.device.type == dev.type for x in tree.leaves(res.params)),
                  f"train {arch} --smoke: {res.metrics}")
            print(f"[train] {arch} --smoke, {TR_SMOKE_ROUNDS} rounds: loss {res.metrics['loss']}, "
                  f"s/round {s_round(res)} (beside the kill/resume processes) [{card}]")
        out, _ = kill_resume.communicate(timeout=600)
    finally:
        if kill_resume.poll() is None:
            kill_resume.kill()
            kill_resume.wait()
    tail = out.strip().splitlines()[-1] if out.strip() else ""
    check(kill_resume.returncode == 0 and tail.startswith("PASS"),
          f"torch_kill_resume_smoke: rc {kill_resume.returncode}, {tail!r}\n{out[-3000:]}")
    print(f"[train] tools/torch_kill_resume_smoke.py --rounds {TR_KILL_ROUNDS} --chunk "
          f"{TR_KILL_CHUNK} on the card (SIGTERM after chunk 2, --resume): {tail}; with the "
          f"{len(CLI_ALIASES)} arch ids' smoke runs {time.perf_counter() - t:.1f} s [{card}]")
    print(f"[train] phase 12 wall {time.perf_counter() - t12:.1f} s [{card}]")


def dry_run_and_examples(dev, card, wrappers):
    """Phase 13: the dry run's CLI and the examples in processes of their
    own, while this one holds the dry run's estimate against the card (see
    DR_*, EST_*, EXAMPLES)."""
    from repro_torch import strategies
    from repro_torch.configs.base import InputShape, get_arch
    from repro_torch.launch import dryrun

    t13 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out_dir = ROOT / "build" / "dryrun_torch_smoke"
    (ROOT / "build" / "examples_torch").mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for shape in DR_SHAPES:
            # host only: the dry run needs no card and must not touch it
            procs[f"dryrun {shape}"] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DR_ARCH, "--shape",
                 shape, "--out", str(out_dir)], cwd=ROOT, env={**env, "CUDA_VISIBLE_DEVICES": ""},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for script, flags, _ in EXAMPLES:
            procs[script] = subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / script), *flags], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        # (b) the estimate against the card, meanwhile
        cfg = get_arch(DR_ARCH).full().replace(n_layers=EST_DEPTH)
        colrel = strategies.get("colrel", fused=False)
        for shape in (InputShape("est_train", 256, 4 * EST_CLIENTS, "train"),
                      InputShape("est_prefill", 1024, 4, "prefill"),
                      InputShape("est_decode", 1024, 4, "decode")):
            step, specs = dryrun.prepare(DR_ARCH, shape, n_clients=EST_CLIENTS,
                                         aggregation=colrel, cfg=cfg)
            t = time.perf_counter()
            fake = dryrun.trace(step, specs)
            fake_s = time.perf_counter() - t
            real, _, _ = run_counted(wrappers, f"estimate {shape.kind}",
                                     lambda: dryrun.measure(step, specs), {})
            gap = (fake["peak_bytes"] - real["peak_bytes"]) / real["peak_bytes"]
            print(f"[dryrun] {DR_ARCH} full width cut to {EST_DEPTH} layers, {shape.kind} kind "
                  f"({shape.global_batch} x {shape.seq_len} tokens"
                  f"{f', {EST_CLIENTS} clients, T = 2, colrel fused=False' if shape.kind == 'train' else ''}"
                  f"): FLOPs fake {fake['flops']:.6e} card {real['flops']:.6e}; peak above the "
                  f"baseline fake {fake['peak_bytes'] / 1e9:.4f} GB card {real['peak_bytes'] / 1e9:.4f}"
                  f" GB (torch.cuda.max_memory_allocated; fake - card {100 * gap:+.2f}%, limit "
                  f"{100 * EST_PEAK_REL:.0f}%); arguments {fake['argument_bytes'] / 1e9:.4f} GB; "
                  f"fake trace {fake_s:.1f} s on the host, the card's step {real['seconds']:.3f} s "
                  f"[{card}]")
            check(fake["flops"] == real["flops"] and fake["flops"] > 0,
                  f"dry run {shape.kind}: fake FLOPs {fake['flops']} != card {real['flops']}")
            check(abs(gap) <= EST_PEAK_REL,
                  f"dry run {shape.kind}: fake peak {fake['peak_bytes']} vs card "
                  f"{real['peak_bytes']}: {100 * gap:+.2f}%")
            check(real["finite"], f"dry run {shape.kind}: the card's outputs are not finite")
            del step, specs
            torch.cuda.empty_cache()

        # (a) the dry run's records, (c) the examples
        for label, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            tail = out.strip().splitlines()[-12:]
            check(proc.returncode == 0, f"{label}: rc {proc.returncode}\n{out[-3000:]}")
            if label.startswith("dryrun"):
                shape = label.split()[1]
                rec = json.loads((out_dir / f"{DR_ARCH}_{shape}_1_colrel.json").read_text())
                check(rec["chips"] == 1 and rec["path"] == "plain" and rec["probe"] is None
                      and rec["hlo_flops_per_chip"] > 0 and rec["collective_bytes_per_chip"] == 0,
                      f"dry run record {shape}: {rec}")
                m, r = rec["memory_analysis"], rec["roofline"]
                peak = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
                print(f"[dryrun] python -m repro_torch.launch.dryrun --arch {DR_ARCH} --shape "
                      f"{shape} (host, fake tensors): FLOPs {rec['hlo_flops_per_chip']:.6e}, "
                      f"unfused bytes {rec['hlo_bytes_per_chip']:.6e}, peak {peak / 1e9:.3f} GB "
                      f"(arguments {m['argument_size_in_bytes'] / 1e9:.3f}), roofline compute "
                      f"{r['compute_s']:.4f} s memory {r['memory_s']:.4f} s -> {r['bottleneck']}, "
                      f"useful FLOP ratio {rec['useful_flop_ratio']:.4f}; build {rec['lower_s']} s, "
                      f"trace {rec['compile_s']} s")
            else:
                marker = next(m_ for s_, _, m_ in EXAMPLES if s_ == label)
                check(any(marker in line for line in tail), f"{label}: no {marker!r} line\n{out}")
                for line in tail:
                    print(f"[examples] {label} (on the card): {line}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[dryrun] phase 13 wall {time.perf_counter() - t13:.1f} s [{card}]")


if __name__ == "__main__":
    sys.exit(main())

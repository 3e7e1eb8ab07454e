#!/usr/bin/env python
"""Times of kernels 1, 2, 3, 4, 5, 6, 7, 9 and 11 of the port on one CUDA card,
with ``chip_smoke.py``'s method, shapes, byte counts and numbers of timed
calls (CUDA events around each call, the L2 cache flushed before it, a
device sleep hiding the host's enqueue; the median of the calls).

    python3 tools/kernel_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so that two trees can be compared on one card,
each in its own process, in turns (parent, change, change, parent).  The
kernels are built from that tree's sources at first use.  Shapes:

* kernels 2 and 5 at the segmented paths' shapes: the 61 leaves of
  cifar_cnn_full (n=10, d=272,282), f32 and int8 for kernel 2 (the colrel
  and quantized paths), f32 into the (n, d) buffer for kernel 5.  ``round``
  times what the tree's strategy launches in a round, in one timed window
  after one flush: one grouped call where the tree has
  ``row_stream_segments_cuda`` / ``memory_stream_segments_cuda``, else the
  61 per-segment calls.  ``per_segment`` times the 61 per-segment calls in
  one window on every tree; ``host_ms`` is the host's time to enqueue a
  window (past chip_smoke's device sleep of ~2 ms, the window also holds
  the host's time).  Kernel 5's ``round_scalar`` is the round on segments
  whose base is one element past an 8-byte boundary, so that every column
  takes the scalar body (one column a thread) in place of the two-column
  one;
* kernel 9 as the segmented clustered path launches it, on the same 61
  f32 segments at n=10 as C=2 clusters of m=5: ``round`` is one grouped
  call where the tree has ``block_row_stream_segments_cuda``, else the 61
  per-segment calls; ``per_segment`` the 61 per-segment calls on every
  tree;
* kernels 1 and 6, ``fused_aggregate_cuda`` and
  ``fused_dequant_aggregate_cuda``: n=10, d=272,282, f32 and int8 (the
  int8 stack is X quantized at 1/40); beside kernel 6, where the tree has
  them, an empty kernel of its grid (``floor_ms``), kernel 2 on the same
  int8 stack with the folded row given (``no_collapse_ms``) and a device
  copy of the stack (``copy_ms``);
* kernel 4, ``fused_memory_update_cuda``: n=10, d=272,282 f32;
* kernel 3, ``relay_mix_cuda``: d=2^20 f32 at n=16 (the main path's and
  ``kernels_bench.py``'s), 33 and 110 (the widest mask the kernel takes);
* kernel 7, ``block_relay_mix_cuda``: C=2 clusters of m=5 (the clustered
  cifar_cnn_full stack), 33 and 110, d=272,282 f32;
* kernel 11, ``ssd_scan_cuda``: ``SSD_PREFILL_SHAPE`` (1024, 4096, 16, 64),
  chunk 64, bf16, on contiguous operands and on the Mamba mixer's views.

Beside each kernel: the bytes it moves, its achieved TB/s, and one PyTorch
call computing the same product where there is one (``torch.matmul``,
``torch.bmm``).  Prints one JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
MIX_MS = (16, 33, 110)    # kernel 3's n
BLOCK_MS = (5, 33, 110)   # kernel 7's m, at C=2
SEG_REPS = 30             # chip_smoke's count for a per-segment call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src on the path; --src goes before it
    import torch

    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs import colrel_paper
    from repro_torch.core import flatten
    from repro_torch.kernels import fused_aggregate as fa
    from repro_torch.kernels import fused_dequant as fdq
    from repro_torch.kernels import fused_memory as fm
    from repro_torch.kernels import ops
    from repro_torch.kernels import relay_block as rb
    from repro_torch.kernels import relay_mix as rm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.cnn import CNN

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    out = {"card": cs.card_line(), "package": str(pathlib.Path(rm.__file__).parents[1])}

    def timed(fn, n_bytes, reps, library=None):
        ms = cs.median_ms(fn, flush, reps)
        row = {"ms": ms, "bytes": n_bytes, "tb_s": n_bytes / ms / 1e9}
        if library is not None:
            row["library_ms"] = cs.median_ms(library, flush, reps)
        return row

    def window(fn, n_bytes):
        """``timed`` of a round's window, with the host's enqueue time (of a
        warm call: the first builds the kernels)."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return dict(timed(fn, n_bytes, SEG_REPS), host_ms=host_ms)

    # kernels 2, 4 and 5 at the segmented paths' shapes
    n = colrel_paper.full().n_clients
    sizes = [math.prod(s) for s in flatten.flat_spec(CNN(colrel_paper.full().cnn)
                                                     .param_tree()).shapes]
    d = sum(sizes)
    grouped = hasattr(fa, "row_stream_segments_cuda")
    out["grouped"] = grouped
    A = torch.rand(n, n, generator=g, device=dev) * 0.5 + 0.1
    tu = (torch.rand(n, generator=g, device=dev) < 0.7).float()
    td = (torch.rand(n, n, generator=g, device=dev) < 0.5).float()
    X = torch.randn(n, d, generator=g, device=dev)
    B = torch.randn(n, d, generator=g, device=dev)
    w = ops.collapsed_weight_row(A, tu, td)
    mix = ops.mixing_mask(A, td)
    segs = [s.contiguous() for s in X.split(sizes, dim=1)]
    q8_segs = [(s * 40).round().clamp(-127, 127).to(torch.int8) for s in segs]
    ws = w / 40
    offs = [sum(sizes[:i]) for i in range(len(sizes))]

    def rows_round(w_, segs_):
        if grouped:
            return lambda: fa.row_stream_segments_cuda(w_, segs_)
        return lambda: [fa.row_stream_cuda(w_, s) for s in segs_]

    def rows_per_segment(w_, segs_):
        return lambda: [fa.row_stream_cuda(w_, s) for s in segs_]

    def memory_round(segs_):
        if grouped:
            return lambda: fm.memory_stream_segments_cuda(mix, tu, segs_, B)
        return memory_per_segment(segs_)

    def memory_per_segment(segs_):
        return lambda: [fm.memory_stream_cuda(mix, tu, s, B[:, o:o + s.shape[1]])
                        for s, o in zip(segs_, offs)]

    def off_by_one(s):
        """A contiguous copy of s whose base is 4 bytes past an 8-byte boundary."""
        flat = torch.empty(s.numel() + 1, dtype=s.dtype, device=dev)
        view = flat[1:].view(s.shape)
        view.copy_(s)
        return view

    row_bytes = 4 * n + 4 * n * d + 4 * d
    row8_bytes = 4 * n + n * d + 4 * d
    mem_bytes = 4 * n * n + 4 * n + 12 * n * d + 4 * d
    out["row_stream"] = {"round": window(rows_round(w, segs), row_bytes),
                         "per_segment": window(rows_per_segment(w, segs), row_bytes),
                         "library_ms": cs.median_ms(lambda: torch.matmul(w, X), flush, 100)}
    out["row_stream_int8"] = {"round": window(rows_round(ws, q8_segs), row8_bytes),
                              "per_segment": window(rows_per_segment(ws, q8_segs), row8_bytes)}

    # kernel 9 on the same f32 segments as C=2 clusters of m=5
    wb = w.reshape(2, n // 2)

    def block_per_segment():
        return [rb.block_row_stream_cuda(wb, s) for s in segs]

    def block_grouped():
        return rb.block_row_stream_segments_cuda(wb, segs)

    block_round = (block_grouped if hasattr(rb, "block_row_stream_segments_cuda")
                   else block_per_segment)
    out["block_row_stream"] = {"round": window(block_round, row_bytes),
                               "per_segment": window(block_per_segment, row_bytes)}

    # kernels 1 and 6 on the monolithic stacks
    q8 = (X * 40).round().clamp(-127, 127).to(torch.int8)
    scale = torch.full((n, 1), 1 / 40, device=dev)
    out["fused_aggregate"] = timed(lambda: fa.fused_aggregate_cuda(A, tu, td, X),
                                   8 * n * n + 4 * n + 4 * n * d + 4 * d, 100,
                                   lambda: torch.matmul(w, X))
    out["fused_dequant_aggregate"] = timed(
        lambda: fdq.fused_dequant_aggregate_cuda(A, tu, td, q8, scale),
        8 * n * n + 8 * n + n * d + 4 * d, 100)
    if hasattr(fdq, "dequant_grid"):
        grid = fdq.dequant_grid(n, d)
        out["fused_dequant_aggregate"].update(
            grid=grid,
            floor_ms=cs.median_ms(lambda: fdq.launch_floor_cuda(grid["blocks"]), flush, 100),
            no_collapse_ms=cs.median_ms(lambda: fa.row_stream_cuda(ws, q8), flush, 100),
            copy_ms=cs.median_ms(lambda: torch.empty_like(q8).copy_(q8), flush, 100))
    del q8
    out["fused_memory_update"] = timed(lambda: fm.fused_memory_update_cuda(A, tu, td, X, B),
                                       8 * n * n + 4 * n + 12 * n * d + 4 * d, 100)
    scalar_segs = [off_by_one(s) for s in segs]
    out["memory_stream"] = {"round": window(memory_round(segs), mem_bytes),
                            "round_scalar": window(memory_round(scalar_segs), mem_bytes),
                            "per_segment": window(memory_per_segment(segs), mem_bytes)}
    del X, B, segs, q8_segs, scalar_segs

    out["relay_mix"] = {}
    for m in MIX_MS:
        M = torch.randn(m, m, generator=g, device=dev)
        X = torch.randn(m, cs.MIX_D, generator=g, device=dev)
        out["relay_mix"][m] = timed(lambda: rm.relay_mix_cuda(M, X),
                                    cs.mix_bytes(1, m, cs.MIX_D, 1), cs.MIX_REPS,
                                    lambda: torch.matmul(M, X))
        del X
    out["block_relay_mix"] = {}
    C, d = 2, cs.D_FULL
    for m in BLOCK_MS:
        Ab = torch.rand(C, m, m, generator=g, device=dev) * 0.5 + 0.1
        tb = (torch.rand(C, m, m, generator=g, device=dev) < 0.5).float()
        X = torch.randn(C * m, d, generator=g, device=dev)
        Mb = rb.block_mixing_mask(Ab, tb)
        out["block_relay_mix"][m] = timed(lambda: rb.block_relay_mix_cuda(Ab, tb, X),
                                          cs.mix_bytes(C, m, d, 2), cs.MIX_REPS,
                                          lambda: torch.bmm(Mb, X.view(C, m, d)))
        del X

    BH, T, Dk, Dv = cs.SSD_PREFILL_SHAPE
    n_bytes = cs.ssd_bytes(BH, T, Dk, Dv)
    bf = torch.bfloat16
    q, k = (torch.randn(BH, T, Dk, generator=g, device=dev, dtype=bf) for _ in range(2))
    v = torch.randn(BH, T, Dv, generator=g, device=dev, dtype=bf)
    logd = -torch.rand(BH, T, generator=g, device=dev)
    out["ssd_scan"] = timed(lambda: ssd.ssd_scan_cuda(q, k, v, logd, chunk=64), n_bytes,
                            cs.SSD_REPS)
    del q, k, v, logd
    views = cs.mamba_views(g, dev, cs.JB_B, BH // cs.JB_B, T, Dk, Dv)
    out["ssd_scan_views"] = timed(lambda: ssd.ssd_scan_cuda(*views, chunk=64), n_bytes,
                                  cs.SSD_REPS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

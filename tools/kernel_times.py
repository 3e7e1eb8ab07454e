#!/usr/bin/env python
"""Times of kernels 3, 7 and 11 of the port on one CUDA card, with
``chip_smoke.py``'s method, shapes, byte counts and numbers of timed calls
(CUDA events around each call, the L2 cache flushed before it, a device
sleep hiding the host's enqueue; the median of the calls).

    python3 tools/kernel_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so that two trees can be compared on one card,
each in its own process, in turns (parent, change, change, parent).  The
kernels are built from that tree's sources at first use.  Shapes:

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
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
MIX_MS = (16, 33, 110)    # kernel 3's n
BLOCK_MS = (5, 33, 110)   # kernel 7's m, at C=2


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
    from repro_torch.kernels import relay_block as rb
    from repro_torch.kernels import relay_mix as rm
    from repro_torch.kernels import ssd_scan as ssd

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

    out["relay_mix"] = {}
    for n in MIX_MS:
        M = torch.randn(n, n, generator=g, device=dev)
        X = torch.randn(n, cs.MIX_D, generator=g, device=dev)
        out["relay_mix"][n] = timed(lambda: rm.relay_mix_cuda(M, X),
                                    cs.mix_bytes(1, n, cs.MIX_D, 1), cs.MIX_REPS,
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

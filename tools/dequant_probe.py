#!/usr/bin/env python
"""Kernel 6 (``fused_dequant_aggregate``) at the quantized path's shape,
n=10, d=272,282 int8, beside what bounds it in the timing harness, and the
candidate designs it was chosen from, each timed on one card in turns.

    python3 tools/dequant_probe.py [--parent SRC]

Needs one CUDA card and ``nvcc``.  Readings, with ``chip_smoke.py``'s
``median_ms`` (the L2 cache flushed before each call, a device sleep
hiding the host's enqueue, CUDA events, the median of 100 calls):

* ``floor_ms`` (a): an empty kernel of kernel 6's grid, the harness's
  floor for a lone launch of it;
* ``no_collapse_ms`` (b): ``row_stream_cuda(ws, q8)``, kernel 2's launch on
  the same int8 stack with the folded weight row given: kernel 6 without
  its collapse;
* ``ms`` (c): kernel 6;
* ``copy_ms`` (d): ``torch.empty_like(q8).copy_(q8)``, a plain device copy
  of the stack;
* ``kernel1_ms``: kernel 1, ``fused_aggregate_cuda``, on the f32 stack of
  the same values, which shares the collapse.

Each candidate is a copy of this checkout's ``src/repro_torch`` with one
edit to ``csrc/fused_aggregate.cu`` (``CANDIDATES``); ``--parent`` names a
parent tree's ``src`` directory, timed as it is.  Only
``fused_aggregate.cu`` is compiled for each (all at once, with ptxas's
report kept for the registers); each is measured in a process of its own,
in the order parent, candidates, then again in reverse.  Prints one JSON
line a measurement and writes them to ``chiprun_out/dequant_probe.jsonl``,
with the card's name and power limit; fails if an edit no longer matches
the source.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D, REPS = 10, 272282, 100
# the candidates: an edit of csrc/fused_aggregate.cu, (old, new) pairs
_GRID = "  const int64_t cols = stream_cols(d, block_d, kDequantV, resident);\n"
_EVEN = ("  const int64_t even = ((d + kDequantV - 1) / kDequantV + {r} - 1) / {r} * kDequantV;\n"
         "  const int64_t cols = even < block_d ? even : block_d;\n")
_GUARDED = ("        if (i < n) {\n"
            "          a[r] = __ldg(A + static_cast<int64_t>(i) * n + j);\n"
            "          t[r] = __ldg(tau_dd + static_cast<int64_t>(j) * n + i);\n"
            "          u[r] = __ldg(tau_up + i);\n"
            "        }\n")
_CLAMPED = ("        {\n"
            "          const int k = i < n ? i : n - 1;\n"
            "          a[r] = __ldg(A + static_cast<int64_t>(k) * n + j);\n"
            "          t[r] = __ldg(tau_dd + static_cast<int64_t>(j) * n + k);\n"
            "          u[r] = __ldg(tau_up + k);\n"
            "        }\n")


def _batch(b):
    return (("constexpr int kCollapseBatch = 12;", f"constexpr int kCollapseBatch = {b};"),)


CANDIDATES = {
    # as committed: the collapse's loads in batches of 12 terms (one round
    # trip at n = 10), each load guarded by i < n; the row stream's grid
    # (some SMs two blocks, others one); 16 int8 columns a thread
    "change": (),
    # collapse batches of 4, 8 and 16 terms (fewer round trips, more
    # registers; 16 spills)
    "collapse_batch_4": _batch(4),
    "collapse_batch_8": _batch(8),
    "collapse_batch_16": _batch(16),
    # every load of a batch issued unguarded, past n clamped to the last term
    "clamped_loads_8": ((_GUARDED, _CLAMPED),) + _batch(8),
    "clamped_loads_12": ((_GUARDED, _CLAMPED),),
    "clamped_loads_16": ((_GUARDED, _CLAMPED),) + _batch(16),
    # the resident blocks sharing d evenly: a block count that is a whole
    # multiple of the SM count, every SM the same bytes
    "grid_even": ((_GRID, _EVEN.format(r="resident")),),
    # one block an SM, sharing d evenly
    "grid_one_block_an_sm": ((_GRID, _EVEN.format(r="sms")),),
    # 8-byte int8 words: more threads of a block hold columns
    "words_8_bytes": (("constexpr int kDequantV = 16;", "constexpr int kDequantV = 8;"),),
}


def copy_with_edits(work: pathlib.Path, label: str) -> pathlib.Path:
    """A copy of this checkout's ``src/repro_torch`` under ``work/label``
    with candidate ``label``'s edits made to ``csrc/fused_aggregate.cu``;
    returns the copy's ``src`` directory."""
    dst = work / label / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "repro_torch" / "kernels" / "csrc" / "fused_aggregate.cu"
    text = cu.read_text()
    for old, new in CANDIDATES[label]:
        if text.count(old) != 1:
            raise RuntimeError(f"{label}: the edit {old!r} does not match the source once")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def measure(src: str, lib_path: str, label: str) -> dict:
    import chip_smoke as cs
    import torch

    sys.path.insert(0, src)
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import fused_aggregate as fa
    from repro_torch.kernels import fused_dequant as fdq
    from repro_torch.kernels import ops

    lib = ctypes.CDLL(lib_path)
    for name, argtypes in build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build.library = lambda: lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    A = torch.rand(N, N, generator=g, device=dev) * 0.5 + 0.1
    tu = (torch.rand(N, generator=g, device=dev) < 0.7).float()
    td = (torch.rand(N, N, generator=g, device=dev) < 0.5).float()
    X = torch.randn(N, D, generator=g, device=dev)
    q8 = (X * 40).round().clamp(-127, 127).to(torch.int8)
    scale = torch.rand(N, 1, generator=g, device=dev) / 40
    ws = ops.fold_dequant_scales(ops.collapsed_weight_row(A, tu, td), scale)
    got = fdq.fused_dequant_aggregate_cuda(A, tu, td, q8, scale)
    out = {"label": label, "card": cs.card_line(),
           "bitwise": torch.equal(got, fdq.fused_dequant_aggregate_plain(A, tu, td, q8, scale))}
    if hasattr(fdq, "dequant_grid"):
        out["grid"] = fdq.dequant_grid(N, D)
        out["floor_ms"] = cs.median_ms(lambda: fdq.launch_floor_cuda(out["grid"]["blocks"]),
                                       flush, REPS)
    out["no_collapse_ms"] = cs.median_ms(lambda: fa.row_stream_cuda(ws, q8), flush, REPS)
    out["ms"] = cs.median_ms(lambda: fdq.fused_dequant_aggregate_cuda(A, tu, td, q8, scale),
                             flush, REPS)
    out["copy_ms"] = cs.median_ms(lambda: torch.empty_like(q8).copy_(q8), flush, REPS)
    out["kernel1_ms"] = cs.median_ms(lambda: fa.fused_aggregate_cuda(A, tu, td, X), flush, REPS)
    return out


def registers(ptxas: str) -> dict:
    """ptxas's registers of each instance of the fused_dequant and
    fused_aggregate kernels, by kernel and mangled template arguments."""
    regs, name = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(fused_(?:dequant|aggregate)_kernel)I(.+?)E?EEv", line)
            name = f"{m[1]}<{m[2]}>" if m else None
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a parent tree's src directory, timed as it is")
    ap.add_argument("--measure", nargs=3, metavar=("SRC", "LIB", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.measure:
        print(json.dumps(measure(*args.measure)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("dequant_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    nvcc = build.find_nvcc()
    work = pathlib.Path(tempfile.mkdtemp(prefix="dequant_probe_"))
    trees = {}
    if args.parent:
        trees["parent"] = pathlib.Path(args.parent).resolve()
    for label in CANDIDATES:
        trees[label] = copy_with_edits(work, label)
    libs, procs = {}, {}
    for label, src in trees.items():
        libs[label] = work / f"{label}.so"
        cu = src / "repro_torch" / "kernels" / "csrc" / "fused_aggregate.cu"
        procs[label] = subprocess.Popen([nvcc, *build._FLAGS, "-shared", "-o", str(libs[label]), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    regs = {}
    for label, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{err}")
        regs[label] = registers(out + err)
    lines = [json.dumps({"registers": regs})]
    print(lines[0], flush=True)
    order = list(trees) + list(reversed(trees))
    for label in order:
        res = subprocess.run([sys.executable, __file__, "--measure", str(trees[label]),
                              str(libs[label]), label], capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            raise RuntimeError(f"{label}: measurement failed\n{res.stderr}")
        lines.append(res.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "dequant_probe.jsonl").write_text("\n".join(lines) + "\n")
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""What ``chip_smoke.py``'s relative-L2 checks of bf16 kernel 11 can see:
the worst relative L2 of the kernel's output against its plain version
over its (slice, chunk) blocks and over its slices, for the kernel as it
is and for three copies of it in which one of its bf16 hi + lo splits
keeps only the hi part:

* ``W``: the weighted scores of the W V product;
* ``S``: the state of the q S product;
* ``k_decay``: k times the decays of the state update.

    python3 tools/ssd_split_probe.py

Needs one CUDA card and ``nvcc``.  Each copy of ``src/repro_torch`` is made
in a temporary directory with its ``ssd_scan.cu`` edited, and all are built
at once; each is then measured in a process of its own at
``chip_smoke.py``'s bf16 shapes of kernel 11 on contiguous operands, at
the prefill shape also with slow decays, and on the Mamba views at the
prefill shape.  Prints one JSON line a copy, each case's readings as
[worst chunk, worst slice], with the card's name and power limit; fails if
an edit no longer matches the source.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (shape, chunk): chip_smoke.py's bf16 cases of kernel 11, then the prefill's
SMALL = (((2, 128, 8, 16), 16), ((2, 128, 8, 16), 32), ((1, 64, 4, 4), 16),
         ((1, 64, 4, 4), 32), ((3, 96, 16, 32), 16), ((3, 96, 16, 32), 32))
# log decays drawn as -U(0, 1) (chip_smoke.py's) and, at the prefill shape,
# also -U(0, 1) * SLOW: a state that lives across chunks, as in a Mamba
# layer whose dt is small, so that the S and k * decay splits show
SLOW = 1 / 16
# the split whose lo part a copy drops: the calls of split2 that make it
CUTS = {"W": "split2(w", "S": "split2(sacc", "k_decay": "split2(f.x"}
SPLIT_END = "  lo = pack2(x0 - hf.x, x1 - hf.y);\n}\n"
HI_ONLY = ("\n__device__ __forceinline__ void split2_hi(float x0, float x1, uint32_t& hi,"
           " uint32_t& lo) {\n  split2(x0, x1, hi, lo);\n  lo = 0u;\n}\n")


def measure() -> dict:
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    out = {"card": cs.card_line(), "package": str(pathlib.Path(ssd.__file__).parents[1])}

    def worst(q, k, v, logd, chunk):
        got = ssd.ssd_scan_cuda(q, k, v, logd, chunk=chunk)
        T = q.shape[-2]
        flat = [x.reshape(-1, T, x.shape[-1]) for x in (q, k, v)]
        want = ssd.ssd_scan_plain(*flat, logd.reshape(-1, T), chunk=chunk)
        return cs.ssd_rel_l2(got.reshape(want.shape), want, chunk)

    cases = [(shape, chunk, 1.0) for shape, chunk in SMALL]
    cases += [(cs.SSD_PREFILL_SHAPE, 64, 1.0), (cs.SSD_PREFILL_SHAPE, 64, SLOW)]
    for shape, chunk, scale in cases:
        BH, T, Dk, Dv = shape
        q, k = (torch.randn(BH, T, Dk, generator=g, device=dev, dtype=bf) for _ in range(2))
        v = torch.randn(BH, T, Dv, generator=g, device=dev, dtype=bf)
        logd = -torch.rand(BH, T, generator=g, device=dev) * scale
        out[f"{shape} chunk {chunk} decay x{scale}"] = worst(q, k, v, logd, chunk)
        del q, k, v, logd
    BH, T, Dk, Dv = cs.SSD_PREFILL_SHAPE
    views = cs.mamba_views(g, dev, cs.JB_B, BH // cs.JB_B, T, Dk, Dv)
    out[f"views {cs.SSD_PREFILL_SHAPE} chunk 64"] = worst(*views, 64)
    readings = [r for key, r in out.items() if "chunk" in key]
    out["worst chunk"] = max(r[0] for r in readings)
    out["worst slice"] = max(r[1] for r in readings)
    return out


def copy_with_cut(dst: pathlib.Path, cut: str | None) -> pathlib.Path:
    src = dst / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if cut is not None:
        cu = src / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
        text = cu.read_text()
        if text.count(SPLIT_END) != 1 or CUTS[cut] not in text:
            raise RuntimeError(f"ssd_split_probe: the {cut} edit no longer matches ssd_scan.cu")
        text = text.replace(SPLIT_END, SPLIT_END + HI_ONLY)
        cu.write_text(text.replace(CUTS[cut], "split2_hi" + CUTS[cut][len("split2"):]))
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="measure this tree's repro_torch (one copy)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # noqa: F401  puts this checkout's src on the path; --src goes before it

    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
        print(json.dumps(measure()))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {name: copy_with_cut(pathlib.Path(tmp) / name, cut)
                for name, cut in [("kernel", None)] + [(f"{c} hi only", c) for c in CUTS]}
        builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import build; "
                                    "build.library()"], env={**os.environ, "PYTHONPATH": str(src)})
                  for src in srcs.values()]
        if any([b.wait() != 0 for b in builds]):  # every build waited for
            raise RuntimeError("ssd_split_probe: a copy did not build")
        for name, src in srcs.items():
            res = subprocess.run([sys.executable, __file__, "--src", str(src)],
                                 stdout=subprocess.PIPE, text=True, check=True)
            row = json.loads(res.stdout.splitlines()[-1])
            if not row["package"].startswith(str(src)):
                raise RuntimeError(f"ssd_split_probe: measured {row['package']}, not {src}")
            print(json.dumps({"copy": name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

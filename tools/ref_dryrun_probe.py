#!/usr/bin/env python3
"""The reference's dry-run depth probes of one arch: XLA's per-device
FLOPs, bytes and collective bytes by type (``repro.launch.dryrun``'s
``_probe_costs``) of ``arch`` x ``shape`` cut to each depth of
``--layers`` on the 16x16 (``single``) or 2x16x16 (``multi``) mesh of
forced host devices, and one layer's share (the last two depths'
difference).  ``tools/torch_dryrun_probe.py`` prints the port's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_dryrun_probe.py \\
        --arch qwen3-0.6b --shape decode_32k --mesh single --layers 1 2

One JSON line a depth (an ``error`` line where the lowering fails), then
one for the layer's share.
"""

import argparse
import json
import sys

import repro.launch.dryrun as dryrun  # first: it forces the 512 host devices
from repro.configs.base import get_arch
from repro.launch.mesh import make_production_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    cfg = get_arch(args.arch).full()
    rows = []
    for k in args.layers:
        try:
            p = dryrun._probe_costs(args.arch, args.shape, mesh, "colrel", None, cfg, k)
        except Exception as e:  # noqa: BLE001 -- a failed lowering is a result
            print(json.dumps({"arch": args.arch, "shape": args.shape, "layers": k,
                              "error": f"{type(e).__name__}: {str(e).splitlines()[0]}"}))
            return 1
        row = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.mesh == "multi" else "16x16", "layers": k,
               "flops": p["flops"], "bytes": p["bytes"], "collectives": p["coll_by_op"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if len(rows) >= 2:
        a, b = rows[-2], rows[-1]
        units = b["layers"] - a["layers"]
        print(json.dumps({
            "per_layer_of": [a["layers"], b["layers"]],
            "flops": (b["flops"] - a["flops"]) / units,
            "bytes": (b["bytes"] - a["bytes"]) / units,
            "collectives": {c: (b["collectives"][c] - a["collectives"][c]) / units
                            for c in b["collectives"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

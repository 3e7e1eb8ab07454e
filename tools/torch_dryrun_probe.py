#!/usr/bin/env python3
"""The port's dry-run counts of one arch at cut depths on a mesh: rank 0's
FLOPs (split by aten op), unfused bytes, collective bytes by type and peak
for ``arch`` x ``shape`` at each depth of ``--layers``, and one layer's
share (the last two depths' difference).  The counterpart of the
reference's depth probes, which ``tools/ref_dryrun_probe.py`` prints.

    PYTHONPATH=src python tools/torch_dryrun_probe.py --arch qwen3-0.6b \\
        --shape decode_32k --mesh single --layers 1 2

``--layers 0`` is the arch's full depth.  ``--show-attention`` adds, a
depth, the global shapes and placements of q, k and v where the first
call of each attention function met them (on a mesh the query blocks meet
them laid out by ``heads_layout``; decode on a sequence-sharded cache
meets them in ``attend_sequence_sharded``).  Fake tensors on a fake
process group on the host: no card is needed.  One JSON line a depth, then one for the layer's share.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def with_depth(cfg, k: int):
    """``cfg`` cut to ``k`` depth units (the reference's ``_with_depth``:
    a hybrid's unit is one attention period)."""
    if k <= 0:
        return cfg
    if cfg.arch_type == "hybrid":
        return cfg.replace(n_layers=k * cfg.attn_every)
    if cfg.arch_type in ("encdec", "audio"):
        return cfg.replace(n_layers=k, n_encoder_layers=k)
    return cfg.replace(n_layers=k)


def _describe(t) -> dict:
    out = {"shape": list(t.shape)}
    if hasattr(t, "placements"):
        out["placements"] = [str(p) for p in t.placements]
        out["mesh"] = list(t.device_mesh.mesh_dim_names)
    return out


def watch_attention() -> dict:
    """Each attention function of ``models.attention`` wrapped to record
    its first call's q, k and v; returns the record, filled as calls come."""
    from repro_torch.models import attention as att

    seen: dict = {}

    def wrap(name):
        real = getattr(att, name)

        def first_call_recorded(q, k, v, *a, **kw):
            seen.setdefault(name, {n: _describe(t) for n, t in (("q", q), ("k", k), ("v", v))})
            return real(q, k, v, *a, **kw)

        setattr(att, name, first_call_recorded)

    for name in ("_sdpa", "_chunked_causal_sdpa", "banded_causal_sdpa",
                 "attend_sequence_sharded"):
        wrap(name)
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="single", choices=sorted(dryrun.MESHES))
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--show-attention", action="store_true")
    args = ap.parse_args(argv)
    full = get_arch(args.arch).full()
    seen = watch_attention() if args.show_attention else None
    rows = []
    for k in args.layers:
        if seen is not None:
            seen.clear()
        rec = dryrun.run_one(args.arch, args.shape, mesh=args.mesh, cfg=with_depth(full, k),
                             by_op=True)
        row = {"arch": args.arch, "shape": args.shape, "mesh": rec["mesh"],
               "layers": k or dryrun._depth_units(full),
               "flops": rec["hlo_flops_per_chip"], "flops_by_op": rec["flops_by_op"],
               "bytes": rec["hlo_bytes_per_chip"], "collectives": rec["collectives"],
               "peak_bytes": (rec["memory_analysis"]["argument_size_in_bytes"]
                              + rec["memory_analysis"]["temp_size_in_bytes"]),
               "trace_s": rec["compile_s"]}
        if seen is not None:
            row["attention"] = dict(seen)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if len(rows) >= 2:
        a, b = rows[-2], rows[-1]
        units = b["layers"] - a["layers"]
        ops = set(a["flops_by_op"]) | set(b["flops_by_op"])
        print(json.dumps({
            "per_layer_of": [a["layers"], b["layers"]],
            "flops": (b["flops"] - a["flops"]) / units,
            "flops_by_op": {o: (b["flops_by_op"].get(o, 0) - a["flops_by_op"].get(o, 0)) / units
                            for o in sorted(ops)},
            "bytes": (b["bytes"] - a["bytes"]) / units,
            "collectives": {c: (b["collectives"][c] - a["collectives"][c]) / units
                            for c in b["collectives"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-card dry run: the cost and the memory of every (arch x input shape)
step, traced on fake tensors, in records with the reference's field names.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The counterpart of ``repro.launch.dryrun``, which lowers each (arch x shape
x mesh) on 512 fake host devices and reads XLA's ``memory_analysis`` and
``cost_analysis``.  The port runs on one device, so ``--mesh`` takes only
``single``, and nothing is allocated: the step of the shape's kind
(:func:`repro_torch.launch.steps.build_step`) and its inputs
(:func:`repro_torch.launch.specs.input_specs`) are made inside one
``FakeTensorMode`` on the ``cpu`` fake device, and the step runs once
under three counters:

* ``torch.utils.flop_counter.FlopCounterMode`` -> ``hlo_flops_per_chip``;
* :class:`ByteCounter`, the bytes of every aten op's tensor inputs and
  outputs (views excluded) -> ``hlo_bytes_per_chip``.  This is the
  unfused count: each op reads its inputs from memory and writes its
  outputs there, as if no two ops were fused;
* ``torch.distributed._tools.mem_tracker.MemTracker``, with the inputs
  registered as external tensors -> the peak; ``temp_size_in_bytes`` is
  the peak less the arguments.

Fake tensors have no data pointer and the hand-written kernels take raw
pointers, so the trace takes each kernel's plain version: every record
says ``"path": "plain"``.  An eager trace counts every layer, so the
reference's depth probes (which exist because XLA counts a rolled scan's
body once) are not ported and ``probe`` is ``null``.  ``lower_s`` is the
seconds to build the step and its fake inputs, ``compile_s`` the seconds of
the counted run.  A decode step writes position ``seq_len - 1`` of its
cache; the plain path's cost does not depend on the position.

:func:`measure` runs the same step materialized on a device, the CUDA
device unless given ``device="cpu"``: the FLOPs ``FlopCounterMode``
counts on real tensors and the peak memory above the baseline before the
inputs (``torch.cuda.max_memory_allocated``; ``MemTracker`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.configs.base import CLI_ALIASES, INPUT_SHAPES, InputShape, get_arch, supported_shapes
from repro_torch.core import flatten
from repro_torch.fl.round import MODES
from repro_torch.fl.trainer import resolve_device
from repro_torch.launch.roofline import count_params_split, model_flops, roofline_terms
from repro_torch.launch.specs import DRYRUN_LOCAL_STEPS, input_specs
from repro_torch.launch.steps import build_step
from repro_torch.models import ModelConfig, build

__all__ = ["RESULTS_DIR", "COLLECTIVES", "ByteCounter", "prepare", "trace", "measure", "run_one",
           "main"]

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
# the reference's collective op names, all at 0 on one card
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def _shape(shape: Union[str, InputShape]) -> InputShape:
    return shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]


def _tokens_for(shape_name: Union[str, InputShape], fl_mode: str) -> float:
    s = _shape(shape_name)
    if s.kind == "train":
        t = 1 if fl_mode == "weighted_grad" else DRYRUN_LOCAL_STEPS
        return float(t * s.global_batch * s.seq_len)
    if s.kind == "prefill":
        return float(s.global_batch * s.seq_len)
    return float(s.global_batch)  # decode: one token per sequence


def _depth_units(cfg: ModelConfig) -> int:
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_leaves(obj) -> list:
    return [x for x in tree.leaves(obj) if isinstance(x, torch.Tensor)]


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; a view
    moves nothing and is not counted.  The unfused count: no op is assumed
    to keep a value on chip for the next."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensor_leaves((args, kwargs, out)))
        return out


def prepare(arch: str, shape: Union[str, InputShape], *, n_clients: int = 16,
            aggregation="colrel", fl_mode: Optional[str] = None,
            cfg: Optional[ModelConfig] = None) -> tuple[Callable, Dict[str, Any]]:
    """``(step, specs)``: the step of the shape's kind for ``arch`` (``cfg``
    overrides its ``full()`` config) and its inputs' meta stand-ins, with
    the strategy (train) and the decode position (decode) added."""
    specs = input_specs(arch, shape, n_clients, cfg=cfg, fl_mode=fl_mode)
    bundle = build(specs["cfg"])
    kind = specs["kind"]
    if kind == "train":
        specs["strategy"] = strategy_registry.resolve(aggregation)
        specs["n_clients"] = int(n_clients)
        step = build_step(bundle, kind, n_clients=n_clients, aggregation=specs["strategy"],
                          fl_mode=fl_mode)
    else:
        step = build_step(bundle, kind)
        if kind == "decode":
            specs["pos"] = _shape(shape).seq_len - 1
    return step, specs


def _args(specs: Dict[str, Any], make: Callable, device: torch.device) -> tuple:
    """The step's positional arguments, each stand-in made by ``make``."""
    conv = lambda t: tree.map(make, t)  # noqa: E731
    kind = specs["kind"]
    if kind == "train":
        params = conv(specs["params"])
        agg_state = specs["strategy"].init_state(specs["n_clients"], flatten.flat_spec(params).d,
                                                 device=device)
        return (params, conv(specs["server_state"]), agg_state, conv(specs["batches"]),
                conv(specs["tau_up"]), conv(specs["tau_dd"]), conv(specs["A"]))
    if kind == "prefill":
        return conv(specs["params"]), conv(specs["batch"])
    return conv(specs["params"]), conv(specs["cache"]), conv(specs["token"]), specs["pos"]


def trace(step: Callable, specs: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``step`` once on fake tensors of ``specs``' shapes and count: FLOPs,
    unfused bytes, the peak, the arguments' and the outputs' bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = _args(specs, lambda m: torch.empty(m.shape, dtype=m.dtype, device=cpu), cpu)
        t_build = time.perf_counter() - t0
        arg_bytes = sum(_nbytes(t) for t in _tensor_leaves(args))
        mem = MemTracker()
        mem.track_external(*_tensor_leaves(args))
        flops, nbytes = FlopCounterMode(display=False), ByteCounter()
        t1 = time.perf_counter()
        with mem, flops, nbytes:
            out = step(*args)
        t_run = time.perf_counter() - t1
        out_bytes = sum(_nbytes(t) for t in _tensor_leaves(out))
        peak = mem.get_tracker_snapshot("peak")[cpu]["Total"]
        del out, args
    return {"flops": float(flops.get_total_flops()), "bytes": float(nbytes.bytes),
            "peak_bytes": int(peak), "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes), "build_s": t_build, "run_s": t_run}


def _materialize(specs: Dict[str, Any], device: torch.device, seed: int) -> tuple:
    g = torch.Generator(device=device).manual_seed(seed)
    vocab = specs["cfg"].vocab_size

    def make(m: torch.Tensor) -> torch.Tensor:
        if m.dtype.is_floating_point:
            return torch.empty(m.shape, dtype=m.dtype, device=device).normal_(0.0, 0.02,
                                                                             generator=g)
        return torch.randint(0, vocab, m.shape, dtype=m.dtype, device=device, generator=g)

    return _args(specs, make, device)


def measure(step: Callable, specs: Dict[str, Any], *, device=None, seed: int = 0) -> Dict[str, Any]:
    """Run ``step`` once on real tensors of ``specs``' shapes on ``device``
    (CUDA unless given ``device="cpu"``): the FLOPs ``FlopCounterMode``
    counts, and the peak bytes above the baseline before the inputs were
    made (the CUDA allocator's ``max_memory_allocated``; ``MemTracker`` on
    the CPU), the inputs included."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    flops = FlopCounterMode(display=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            args = _materialize(specs, dev, seed)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with flops:
            out = step(*args)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
    else:
        from torch.distributed._tools.mem_tracker import MemTracker

        with torch.no_grad():
            args = _materialize(specs, dev, seed)
        mem = MemTracker()
        mem.track_external(*_tensor_leaves(args))
        t0 = time.perf_counter()
        with mem, flops:
            out = step(*args)
        seconds = time.perf_counter() - t0
        peak = mem.get_tracker_snapshot("peak")[dev]["Total"]
    finite = all(bool(torch.isfinite(t).all()) for t in _tensor_leaves(out)
                 if t.dtype.is_floating_point)
    del out, args
    return {"flops": float(flops.get_total_flops()), "peak_bytes": int(peak), "seconds": seconds,
            "finite": finite, "device": str(dev)}


def run_one(arch: str, shape: Union[str, InputShape], *, n_clients: int = 16,
            aggregation="colrel", fl_mode: Optional[str] = None, tag: str = "",
            static_window: bool = False, cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One dry-run record of ``arch`` x ``shape`` on one device.  The default
    16 clients are what the reference's single-pod 16 x 16 mesh gives."""
    if cfg is None:
        cfg = get_arch(arch).full()
    if static_window:
        cfg = cfg.replace(static_window_pattern=True)
    t0 = time.perf_counter()
    step, specs = prepare(arch, shape, n_clients=n_clients, aggregation=aggregation,
                          fl_mode=fl_mode, cfg=cfg)
    t_prepare = time.perf_counter() - t0
    got = trace(step, specs)
    flops, byts = got["flops"], got["bytes"]
    terms = roofline_terms(flops, byts)
    pcounts = count_params_split(specs["params"], cfg.n_experts, cfg.top_k)
    kind = specs["kind"]
    mode = fl_mode or cfg.fl_mode
    mflops = model_flops("train" if kind == "train" else "serve", pcounts["active"],
                         _tokens_for(shape, mode))
    arg = got["argument_bytes"]
    mem_attrs = {
        "argument_size_in_bytes": arg,
        "output_size_in_bytes": got["output_bytes"],
        "temp_size_in_bytes": got["peak_bytes"] - arg,
        "argument_bytes_global": arg,
        "argument_bytes_per_shard": arg,
    }
    shape_name = _shape(shape).name
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "1",
        "chips": 1,
        "n_clients": int(n_clients),
        "aggregation": strategy_registry.canonical_name(aggregation),
        "fl_mode": mode,
        "tag": tag,
        "lower_s": round(t_prepare + got["build_s"], 2),
        "compile_s": round(got["run_s"], 2),
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": byts,
        "collective_bytes_per_chip": 0.0,
        "collectives": {c: 0 for c in COLLECTIVES},
        "roofline": terms,
        "params_total": pcounts["total"],
        "params_active": pcounts["active"],
        "model_flops_per_chip": mflops,
        "useful_flop_ratio": (mflops / flops) if flops else None,
        "memory_analysis": mem_attrs,
        "probe": None,
        "path": "plain",
    }
    print(f"== {arch} x {shape_name} x 1 card (agg={record['aggregation']}, mode={mode}"
          f"{', ' + tag if tag else ''}, {n_clients} clients, path=plain)")
    print(f"   memory: {mem_attrs}, peak {got['peak_bytes'] / 1e9:.3f} GB")
    print(f"   cost: flops={flops:.4e} bytes={byts:.4e} (unfused)")
    print(f"   roofline (H100 SXM): compute={terms['compute_s']:.4f}s "
          f"memory={terms['memory_s']:.4f}s collective=0 -> {terms['bottleneck']}")
    print(f"   useful_flop_ratio={record['useful_flop_ratio'] and round(record['useful_flop_ratio'], 3)}"
          f" build={record['lower_s']:.1f}s trace={record['compile_s']:.1f}s", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (CLI form) or 'all'")
    ap.add_argument("--shape", default=None, help="input shape name or 'all'")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"],
                    help="only 'single': the port runs on one device")
    ap.add_argument("--all", action="store_true", help="every supported arch x shape")
    ap.add_argument("--aggregation", default="colrel",
                    choices=sorted(strategy_registry.available()))
    ap.add_argument("--fl-mode", default=None, choices=[None, *MODES])
    ap.add_argument("--tag", default="", help="label recorded for perf iterations")
    ap.add_argument("--static-window", action="store_true",
                    help="unrolled static local/global pattern (banded attention)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.mesh != "single":
        ap.error(f"--mesh {args.mesh}: the port runs on one device; only --mesh single")

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(CLI_ALIASES) if (args.all or args.arch in (None, "all")) else [args.arch]
    n_ok = n_fail = 0
    for arch in archs:
        shapes = supported_shapes(arch) if (args.all or args.shape in (None, "all")) \
            else [args.shape]
        for shape in shapes:
            if shape not in supported_shapes(arch):
                print(f"-- skipping unsupported {arch} x {shape}")
                continue
            suffix = f"_{args.tag}" if args.tag else ""
            fname = out_dir / f"{arch}_{shape}_1_{args.aggregation}{suffix}.json"
            if args.skip_existing and fname.exists():
                print(f"-- cached {fname.name}")
                n_ok += 1
                continue
            try:
                rec = run_one(arch, shape, aggregation=args.aggregation, fl_mode=args.fl_mode,
                              tag=args.tag, static_window=args.static_window)
                fname.write_text(json.dumps(rec, indent=1))
                n_ok += 1
            except Exception:  # one failed combination must not stop the sweep
                n_fail += 1
                print(f"!! FAILED {arch} x {shape} x 1")
                traceback.print_exc()
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())

"""Dry run: the cost and the memory of every (arch x input shape x mesh)
step, traced on fake tensors, in records with the reference's field names.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card

The counterpart of ``repro.launch.dryrun``, which lowers each (arch x shape
x mesh) on 512 fake host devices and reads XLA's ``memory_analysis``,
``cost_analysis`` and partitioned HLO.  ``--mesh`` takes the reference's
meshes and one more:

* ``single`` — the 16 x 16 ``(data, model)`` mesh of 256 devices, 16
  clients; ``multi`` — the 2 x 16 x 16 ``(pod, data, model)`` mesh of 512,
  32 clients; ``both`` — the two.  The process joins a fake process group
  (``torch.testing._internal.distributed.fake_pg``) of the mesh's world
  size as rank 0, builds the mesh on the ``cpu`` device type, and traces
  rank 0's share of the step
  (:func:`repro_torch.launch.steps.build_step`'s reference form): its
  clients on the model sub-mesh, its shards of every input as DTensors
  over fake local tensors.  The fake group's collectives move nothing.
* ``card`` — one device, the step traced whole at 16 clients (the
  single-pod mesh's count): records with ``"mesh": "1"``.

Every trace runs the step once under a :class:`StepCounter` and a memory
tracker, inside one ``FakeTensorMode``, so nothing is allocated:

* ``hlo_flops_per_chip`` — the FLOPs of the local (per-device) aten ops.
  DTensor ops are not counted at their global shapes: the counter passes
  them on (``NotImplemented``) and counts the local ops they run;
* ``hlo_bytes_per_chip`` — the bytes of every local aten op's tensor
  inputs and outputs (views and collectives excluded): the unfused count,
  each op reading its inputs from memory and writing its outputs there;
* ``collectives`` — the output bytes of each functional collective one
  rank issues, under the reference's five names; their sum is
  ``collective_bytes_per_chip``;
* the peak of ``torch.distributed._tools.mem_tracker.MemTracker`` over
  local storages, the inputs registered as external tensors;
  ``temp_size_in_bytes`` is the peak less this rank's arguments, and
  ``argument_bytes_per_shard`` / ``argument_bytes_global`` are the
  arguments' bytes on one rank and whole.

Fake tensors have no data pointer and the hand-written kernels take raw
pointers, so the trace takes each kernel's plain version: every record
says ``"path": "plain"``.  An eager trace counts every layer, so the
reference's depth probes (which exist because XLA counts a rolled scan's
body once) are not ported and ``probe`` is ``null``.  ``lower_s`` is the
seconds to build the step and its fake inputs, ``compile_s`` the seconds of
the counted run.  A decode step writes position ``seq_len - 1`` of its
cache; the plain path's cost does not depend on the position.

:func:`measure` runs the one-device step materialized on a device, the
CUDA device unless given ``device="cpu"``: the FLOPs counted on real
tensors and the peak memory above the baseline before the inputs
(``torch.cuda.max_memory_allocated``; ``MemTracker`` on the CPU).
:func:`measure_mesh` does the same for a step on a real mesh.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Union

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.configs.base import CLI_ALIASES, INPUT_SHAPES, InputShape, get_arch, supported_shapes
from repro_torch.core import flatten
from repro_torch.dist.mesh import make_production_mesh, n_clients as mesh_clients
from repro_torch.fl.round import MODES
from repro_torch.fl.trainer import resolve_device
from repro_torch.launch.roofline import (COLLECTIVES, collective_name, count_params_split,
                                         model_flops, roofline_terms)
from repro_torch.launch.specs import DRYRUN_LOCAL_STEPS, input_specs
from repro_torch.launch.steps import build_step, place
from repro_torch.models import ModelConfig, build

__all__ = ["RESULTS_DIR", "COLLECTIVES", "MESHES", "StepCounter", "fake_group",
           "prepare", "prepare_mesh", "trace", "trace_mesh", "measure", "measure_mesh",
           "run_one", "main"]

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
#: --mesh name -> (record tag, multi_pod); "card" is one device
MESHES = {"card": ("1", None), "single": ("16x16", False), "multi": ("2x16x16", True)}


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


def _is_dtensor_type(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")  # no DTensor before it is imported
    return mod is not None and issubclass(t, mod.DTensor)


class StepCounter(TorchDispatchMode):
    """One device's share of a step: the FLOPs of its aten ops (by
    ``torch.utils.flop_counter``'s formulas); their unfused bytes, each
    non-view op's tensor inputs and outputs (no op assumed to keep a value
    on chip for the next; collectives excluded); and the output bytes of
    each functional collective under the reference's names.  ``by_op``
    splits the FLOPs by aten op (``"aten.mm"``, ...), the record's
    ``flops_by_op``.

    A DTensor op is passed on (``NotImplemented``), so that DTensor runs it
    as local ops on the shards, which this mode then counts: the counts
    are per device, not at the DTensor's global shapes.  DTensor's sharding
    propagation runs each new (op, shapes, placements) once on fake
    tensors of the global shapes: under a fake mode of its own on real
    tensors, which this mode tells apart and skips (as ``MemTracker``
    does), but under the ambient one in a fake trace, so a mesh trace runs
    the step once before it counts (:func:`_warm_run`), and every op of
    the counted run then finds its propagation cached."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.by_op: Dict[str, int] = {}
        self.bytes = 0
        self.collectives = {c: 0 for c in COLLECTIVES}

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._mode_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.utils.flop_counter import flop_registry

        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._mode_on_entry:
            return out
        name = collective_name(func)
        if name is not None:
            self.collectives[name] += sum(_nbytes(t) for t in _tensor_leaves(out))
            return out
        if func.namespace.endswith("c10d_functional"):  # wait_tensor and the like
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + n
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensor_leaves((args, kwargs, out)))
        return out


def _mem_tracker():
    """A ``MemTracker`` of local storages: DTensor ops are passed on, so that
    it sees their local ops (which newer torch's tracker does itself)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(_is_dtensor_type(t) for t in types):
                return NotImplemented
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (collectives return at once and move nothing); the default
    group is destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


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


def _local_leaves(obj) -> list:
    """The tensors of ``obj``, a DTensor's local tensor for a DTensor."""
    return [t.to_local() if hasattr(t, "to_local") else t for t in _tensor_leaves(obj)]


def _warm_run(step: Callable, args: tuple) -> None:
    """``step(*args)`` once, uncounted: DTensor's sharding propagation
    caches every (op, shapes, placements) the step meets."""
    out = step(*args)
    del out


def _counted_run(step: Callable, args: tuple) -> Dict[str, Any]:
    """``step(*args)`` once under a :class:`StepCounter` and a memory
    tracker: the counts of one device and its peak."""
    mem = _mem_tracker()
    mem.track_external(*_local_leaves(args))
    counter = StepCounter()
    t1 = time.perf_counter()
    with mem, counter:
        out = step(*args)
    t_run = time.perf_counter() - t1
    # every device the tracker saw: one device a process
    peak = sum(v.get("Total", 0) for v in mem.get_tracker_snapshot("peak").values())
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "flops_by_op": {k: float(v) for k, v in sorted(counter.by_op.items(),
                                                            key=lambda kv: -kv[1])},
            "collectives": dict(counter.collectives), "peak_bytes": int(peak),
            "output_bytes": int(sum(_nbytes(t) for t in _local_leaves(out))), "run_s": t_run,
            "out": out}


def trace(step: Callable, specs: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``step`` once on fake tensors of ``specs``' shapes and count: FLOPs,
    unfused bytes, the peak, the arguments' and the outputs' bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = _args(specs, lambda m: torch.empty(m.shape, dtype=m.dtype, device=cpu), cpu)
        t_build = time.perf_counter() - t0
        arg_bytes = sum(_nbytes(t) for t in _tensor_leaves(args))
        got = _counted_run(step, args)
        del got["out"], args
    return dict(got, argument_bytes=int(arg_bytes), argument_bytes_global=int(arg_bytes),
                build_s=t_build)


def prepare_mesh(arch: str, shape: Union[str, InputShape], mesh, *, aggregation="colrel",
                 fl_mode: Optional[str] = None, cfg: Optional[ModelConfig] = None,
                 n_clients: Optional[int] = None) -> tuple[Callable, tuple, Any]:
    """``(step, args, in_shardings)`` of ``arch`` x ``shape`` on ``mesh``
    (:func:`~repro_torch.launch.steps.build_step`'s reference form; the
    mesh's client count unless given a multiple of it), the args as meta
    tensors, the decode position as ``seq_len - 1``."""
    step, args, in_sh, _ = build_step(arch, shape, mesh, n_clients=n_clients,
                                      aggregation=aggregation, fl_mode=fl_mode,
                                      cfg_override=cfg)
    if _shape(shape).kind == "decode":
        args = (*args[:3], _shape(shape).seq_len - 1)
    return step, args, in_sh


def _shard_args(args: tuple, in_sh, make: Callable) -> tuple:
    """Each meta arg made whole by ``make`` and laid out by its sharding."""
    whole = tree.map(lambda m: make(m) if isinstance(m, torch.Tensor) else m, args)
    return place(whole, in_sh)


def trace_mesh(step: Callable, args: tuple, in_sh) -> Dict[str, Any]:
    """Rank 0's share of ``step`` on its mesh (a fake group's), traced on
    fake tensors: :func:`trace`'s counts of one device, its collectives'
    bytes, and the arguments' bytes on this rank and whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with FakeTensorMode():
        dargs = _shard_args(args, in_sh, lambda m: torch.empty(m.shape, dtype=m.dtype,
                                                              device=cpu))
        t_build = time.perf_counter() - t0
        arg_global = sum(_nbytes(t) for t in _tensor_leaves(dargs))
        arg_shard = sum(_nbytes(t) for t in _local_leaves(dargs))
        _warm_run(step, dargs)
        got = _counted_run(step, dargs)
        del got["out"], dargs
    return dict(got, argument_bytes=int(arg_shard), argument_bytes_global=int(arg_global),
                build_s=t_build)


def measure_mesh(step: Callable, args: tuple, in_sh, *, vocab: int, seed: int = 0,
                 device=None) -> Dict[str, Any]:
    """Rank ``step`` on a real mesh: every rank makes the same whole inputs
    from ``seed`` (floats N(0, 0.02), ints below ``vocab``), keeps its
    shards, and runs the step once under :func:`trace_mesh`'s counters;
    this rank's counts, its peak (``MemTracker``; on CUDA the allocator's
    peak above the baseline) and whether its outputs are finite."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(m):
        if m.dtype.is_floating_point:
            return torch.empty(m.shape, dtype=m.dtype, device=dev).normal_(0.0, 0.02, generator=g)
        return torch.randint(0, vocab, m.shape, dtype=m.dtype, device=dev, generator=g)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
    with torch.no_grad():
        dargs = _shard_args(args, in_sh, make)
    _warm_run(step, dargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    got = _counted_run(step, dargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        got["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev) - base)
    out = got.pop("out")
    got["finite"] = all(bool(torch.isfinite(t).all()) for t in _local_leaves(out)
                        if t.dtype.is_floating_point)
    got["argument_bytes"] = int(sum(_nbytes(t) for t in _local_leaves(dargs)))
    return got


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
    (CUDA unless given ``device="cpu"``): the FLOPs :class:`StepCounter`
    counts, and the peak bytes above the baseline before the inputs were
    made (the CUDA allocator's ``max_memory_allocated``; ``MemTracker`` on
    the CPU), the inputs included."""

    dev = resolve_device(device)
    flops = StepCounter()
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
        with torch.no_grad():
            args = _materialize(specs, dev, seed)
        mem = _mem_tracker()
        mem.track_external(*_tensor_leaves(args))
        t0 = time.perf_counter()
        with mem, flops:
            out = step(*args)
        seconds = time.perf_counter() - t0
        peak = mem.get_tracker_snapshot("peak")[dev]["Total"]
    finite = all(bool(torch.isfinite(t).all()) for t in _tensor_leaves(out)
                 if t.dtype.is_floating_point)
    del out, args
    return {"flops": float(flops.flops), "peak_bytes": int(peak), "seconds": seconds,
            "finite": finite, "device": str(dev)}


def run_one(arch: str, shape: Union[str, InputShape], *, mesh: str = "card", n_clients: int = 16,
            aggregation="colrel", fl_mode: Optional[str] = None, tag: str = "",
            static_window: bool = False, cfg: Optional[ModelConfig] = None,
            by_op: bool = False) -> Dict[str, Any]:
    """One dry-run record of ``arch`` x ``shape`` on ``mesh`` (a key of
    :data:`MESHES`).  On one card the step runs ``n_clients`` clients, 16 by
    default, the single-pod mesh's count; on a mesh the mesh gives them.
    ``by_op`` adds ``flops_by_op`` (``--by-op``), the FLOPs of each aten op."""
    tag_name, multi_pod = MESHES[mesh]
    if cfg is None:
        cfg = get_arch(arch).full()
    if static_window:
        cfg = cfg.replace(static_window_pattern=True)
    mode = fl_mode or cfg.fl_mode
    t0 = time.perf_counter()
    if multi_pod is None:
        chips = 1
        step, specs = prepare(arch, shape, n_clients=n_clients, aggregation=aggregation,
                              fl_mode=fl_mode, cfg=cfg)
        t_prepare = time.perf_counter() - t0
        got = trace(step, specs)
        params = specs["params"]
    else:
        chips = 512 if multi_pod else 256
        with fake_group(chips):
            m = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            n_clients = mesh_clients(m)
            step, args, in_sh = prepare_mesh(arch, shape, m, aggregation=aggregation,
                                             fl_mode=fl_mode, cfg=cfg)
            t_prepare = time.perf_counter() - t0
            got = trace_mesh(step, args, in_sh)
        params = args[0]
    flops, byts = got["flops"], got["bytes"]
    coll = got["collectives"]
    coll_total = float(sum(coll.values()))
    terms = roofline_terms(flops, byts, coll_total)
    pcounts = count_params_split(params, cfg.n_experts, cfg.top_k)
    kind = _shape(shape).kind
    mflops = model_flops("train" if kind == "train" else "serve", pcounts["active"],
                         _tokens_for(shape, mode)) / chips
    arg = got["argument_bytes"]
    mem_attrs = {
        "argument_size_in_bytes": arg,
        "output_size_in_bytes": got["output_bytes"],
        "temp_size_in_bytes": got["peak_bytes"] - arg,
        "argument_bytes_global": got["argument_bytes_global"],
        "argument_bytes_per_shard": arg,
    }
    shape_name = _shape(shape).name
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": tag_name,
        "chips": chips,
        "n_clients": int(n_clients),
        "aggregation": strategy_registry.canonical_name(aggregation),
        "fl_mode": mode,
        "tag": tag,
        "lower_s": round(t_prepare + got["build_s"], 2),
        "compile_s": round(got["run_s"], 2),
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": byts,
        "collective_bytes_per_chip": coll_total,
        "collectives": coll,
        "roofline": terms,
        "params_total": pcounts["total"],
        "params_active": pcounts["active"],
        "model_flops_per_chip": mflops,
        "useful_flop_ratio": (mflops / flops) if flops else None,
        "memory_analysis": mem_attrs,
        "probe": None,
        "path": "plain",
    }
    if by_op:
        record["flops_by_op"] = got["flops_by_op"]
    where = "1 card" if chips == 1 else f"{tag_name} ({chips} devices, rank 0)"
    print(f"== {arch} x {shape_name} x {where} (agg={record['aggregation']}, mode={mode}"
          f"{', ' + tag if tag else ''}, {n_clients} clients, path=plain)")
    print(f"   memory: {mem_attrs}, peak {got['peak_bytes'] / 1e9:.3f} GB")
    print(f"   cost: flops/chip={flops:.4e} bytes/chip={byts:.4e} (unfused); by op "
          f"{ {k: f'{v:.3e}' for k, v in got['flops_by_op'].items()} }")
    print(f"   collectives/chip: {coll_total:.4e} B "
          f"{ {k: f'{v:.3e}' for k, v in coll.items() if v} }")
    print(f"   roofline (H100 SXM): compute={terms['compute_s']:.4f}s "
          f"memory={terms['memory_s']:.4f}s collective={terms['collective_s']:.4f}s "
          f"-> {terms['bottleneck']}")
    print(f"   useful_flop_ratio={record['useful_flop_ratio'] and round(record['useful_flop_ratio'], 3)}"
          f" build={record['lower_s']:.1f}s trace={record['compile_s']:.1f}s", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (CLI form) or 'all'")
    ap.add_argument("--shape", default=None, help="input shape name or 'all'")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "card"],
                    help="16x16 (single), 2x16x16 (multi), both, or one device (card)")
    ap.add_argument("--all", action="store_true", help="every supported arch x shape")
    ap.add_argument("--aggregation", default="colrel",
                    choices=sorted(strategy_registry.available()))
    ap.add_argument("--fl-mode", default=None, choices=[None, *MODES])
    ap.add_argument("--tag", default="", help="label recorded for perf iterations")
    ap.add_argument("--static-window", action="store_true",
                    help="unrolled static local/global pattern (banded attention)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--by-op", action="store_true",
                    help="add flops_by_op, the per-device FLOPs of each aten op, to the records")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(CLI_ALIASES) if (args.all or args.arch in (None, "all")) else [args.arch]
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    n_ok = n_fail = 0
    for arch in archs:
        shapes = supported_shapes(arch) if (args.all or args.shape in (None, "all")) \
            else [args.shape]
        for shape in shapes:
            if shape not in supported_shapes(arch):
                print(f"-- skipping unsupported {arch} x {shape}")
                continue
            for mesh in meshes:
                mesh_tag = MESHES[mesh][0]
                suffix = f"_{args.tag}" if args.tag else ""
                fname = out_dir / f"{arch}_{shape}_{mesh_tag}_{args.aggregation}{suffix}.json"
                if args.skip_existing and fname.exists():
                    print(f"-- cached {fname.name}")
                    n_ok += 1
                    continue
                try:
                    rec = run_one(arch, shape, mesh=mesh, aggregation=args.aggregation,
                                  fl_mode=args.fl_mode, tag=args.tag,
                                  static_window=args.static_window, by_op=args.by_op)
                    fname.write_text(json.dumps(rec, indent=1))
                    n_ok += 1
                except Exception:  # one failed combination must not stop the sweep
                    n_fail += 1
                    print(f"!! FAILED {arch} x {shape} x {mesh_tag}")
                    traceback.print_exc()
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the traced segment, the
comparison with the plain reference, and the result line.

    set-up   inputs from the seed (weights on the device, the clients' shards,
             the taus, COPT-alpha), the port's trainer, and its first chunk
             through the trainer's own entry, ``FLTrainer.run(K, chunk=K)``:
             the round's warm-up, capture and first K replays.  What the
             first chunk produced is read for the comparison.
    window   one call ``FLTrainer.run(m * K, chunk=K)``, as a user's long run
             makes it: the host stacks each chunk's batches while the device
             replays the chunk before.  m is the chunks that fill
             ``--seconds`` at the first chunk's pace (its fenced time less
             the warm-up, capture and instantiation); should they fall
             short, one more call of the chunks still wanting follows.  The
             window ends at the end of the last chunk.
    trace    (``--trace 1``) one more call of two chunks under the profiler.
    check    the program's state freed, the reference follows the first
             chunk's rounds from the same inputs (TF32 off) and the
             numbers of :mod:`benchlib.check` decide ``correct``.

The last line of standard output is the result as one JSON object; the
numbers compared are the last lines of standard error and the last key of
the result.  ``--rehearse`` runs the cell at the configuration's
``rehearse`` sizes on the CPU: the result names the CPU and carries no
metric of the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import platform
import sys
import time
from typing import Any, Dict, List, Optional

from benchlib import check, data, hw, links
from benchlib import trace as tracing
from benchlib.registry import Registry

__all__ = ["main", "run_cell", "Cell", "reference_readout", "merged", "FORBIDDEN_MODULES"]

#: top-level module names that may not be loaded in the process that prints
#: the result: JAX, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def merged(base: Dict[str, Any], over: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _cache_dirs(root) -> None:
    """Every compile cache of the program inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_loaded() -> List[str]:
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN_MODULES)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


class Cell:
    """The inputs of one run, made from the seed; both sides read them.

    What the configuration and the traffic name is looked up by that name:
    the family (``families/``, ``reference/``), the topology
    (``topologies/<kind>.py``), the channel law (``channels/<traffic's
    channel>.py``) and the round (the traffic's ``round``: the program's
    strategy, its options and mode, the launches the captured round must
    hold, and the plain reference of its rounds, ``reference/<name>.py``)."""

    def __init__(self, reg: Registry, config, traffic, seed: int, device):
        self.config, self.seed, self.device = config, int(seed), device
        self.family = reg.module("families", config["family"])
        self.reference = reg.module("reference", config["family"])
        self.round = traffic["round"]
        self.rounds_reference = reg.module("reference", self.round["reference"])
        self.channel = reg.module("channels", traffic["channel"])
        p = config["protocol"]
        self.K = int(traffic["chunk"])
        self.T = int(p["local_steps"])
        self.batch = int(traffic.get("batch_size", p.get("batch_size", 0)))
        self.links = reg.module("topologies", p["topology"]["kind"]).links(p["topology"])
        self.A = links.copt_alpha(self.links, int(p["alpha"]["sweeps"]),
                                  int(p["alpha"]["fine_tune_sweeps"]))
        self.shards = self.family.make_shards(config, traffic, self.seed, device)

    def streams(self):
        return data.streams(self.shards, self.batch, self.seed)


def _program(cell: Cell):
    """The port's trainer over the cell's inputs, and the initial weights."""
    from repro_torch import strategies
    from repro_torch.fl.trainer import FLTrainer
    from repro_torch.optim import sgd, sgd_momentum

    p, rnd = cell.config["protocol"], cell.round
    loss_fn, tree_of = cell.family.program(cell.config, cell.device)
    params0 = cell.family.make_params(cell.config, cell.seed, cell.device)
    trainer = FLTrainer(
        loss_fn, tree_of(params0), None, cell.A, cell.streams(),
        sgd(float(p["client_lr"]), weight_decay=float(p["weight_decay"])),
        sgd_momentum(float(p["server_lr"]), beta=float(p["server_momentum"])),
        local_steps=cell.T, strategy=strategies.get(rnd["strategy"], **rnd.get("options", {})),
        mode=rnd["mode"], channel=cell.channel.program_channel(cell.links, cell.seed),
        seed=cell.seed, device=cell.device)
    return trainer, params0


def _flat(tree_mod, t) -> Dict[str, Any]:
    return dict(zip(tree_mod.paths(t), tree_mod.leaves(t)))


def _program_readout(cell: Cell, trainer, params0) -> Dict[str, object]:
    """What the first chunk produced: its rounds' metrics, and the norms of
    the PS momentum and of the parameters' change, leaf by leaf."""
    from repro_torch import tree

    K, fam = cell.K, cell.family
    rm = trainer.round_metrics
    params = _flat(tree, trainer.params)
    change = {k: params[k].float() - params0[k].float() for k in params0}
    momentum = fam.comparison_leaves(_flat(tree, trainer.server_state["m"]))
    return check.readout(rm["loss"][:K], rm["delta_norm"][:K], check.leaf_norms(momentum),
                         check.leaf_norms(fam.comparison_leaves(change)))


def reference_readout(cell: Cell, prec: str = "f32", fault: Optional[str] = None):
    """The plain reference over the first chunk's rounds, from the inputs
    made anew from the seed."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = cell.config["protocol"]
    params0 = cell.family.make_params(cell.config, cell.seed, cell.device)
    out = cell.rounds_reference.run_rounds(
        cell.reference.make_loss(cell.config["model"]), params0, cell.streams(),
        cell.channel.reference_taus(cell.links, cell.seed, cell.K), cell.A, local_steps=cell.T,
        chunk=cell.K, rounds=cell.K, lr=float(p["client_lr"]),
        weight_decay=float(p["weight_decay"]), beta=float(p["server_momentum"]), prec=prec,
        fault=fault, device=cell.device)
    fam = cell.family
    change = {k: out["params"][k].float() - params0[k].float() for k in params0}
    return check.readout(out["loss"], out["delta_norm"],
                         check.leaf_norms(fam.comparison_leaves(out["momentum"])),
                         check.leaf_norms(fam.comparison_leaves(change)))


def _per_layer(reg: Registry, workload: str, view) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in reg.metrics(workload, "per_layer"):
        value = reg.reader(m["name"]).read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(reg: Registry, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, rehearse: bool = False) -> Dict[str, Any]:
    """One run of ``workload``; returns the result line's object."""
    import torch

    cell_entry = reg.cell(workload)
    config = reg.data("configs", cell_entry["config"])
    traffic = reg.data("traffic", cell_entry["traffic"])
    limits = reg.data("workloads", workload)["limits"]
    if rehearse:
        config = merged(config, config.get("rehearse"))
        traffic = merged(traffic, traffic.get("rehearse"))
        device = torch.device("cpu")
    else:
        device = torch.device("cuda")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    prec = config["precision"]
    torch.backends.cudnn.allow_tf32 = bool(prec["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["matmul_allow_tf32"])

    # -- set-up: inputs, the trainer, its first chunk --------------------------
    t_in = time.perf_counter()
    cell = Cell(reg, config, traffic, seed, device)
    K = cell.K
    if device.type == "cuda":
        # the peak is the program's: the shards are made and moved to the host
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_prog = time.perf_counter()
    trainer, params0 = _program(cell)
    t_run = time.perf_counter()
    trainer.run(K, chunk=K)
    sync()
    _log(f"[bench] set-up phases: start to inputs {t_in - t_start:.3f} s, inputs "
         f"{t_prog - t_in:.3f} s, trainer and weights {t_run - t_prog:.3f} s, first chunk "
         f"{time.perf_counter() - t_run:.3f} s")
    prog = _program_readout(cell, trainer, params0)
    del params0
    gc.collect()
    stats = dict(getattr(trainer._scan_fn, "stats", {}) or {})
    setup_s = time.perf_counter() - t_start
    _log(f"[bench] {workload} seed {seed}: set-up {setup_s:.3f} s (warm-up "
         f"{stats.get('warmup_s', float('nan')):.3f}, capture {stats.get('capture_s', float('nan')):.3f},"
         f" instantiate {stats.get('instantiate_s', float('nan')):.3f}), pool "
         f"{stats.get('pool_bytes', 0) / 1e9:.3f} GB")

    # -- the measured window: one long call of the trainer (one more, should
    # the first chunk's pace have promised too much) -------------------------
    pace = trainer.meter.chunks[-1]["seconds"] - sum(
        float(stats.get(k, 0.0)) for k in ("warmup_s", "capture_s", "instantiate_s"))
    pace = max(pace, 1e-3)  # seconds a chunk
    calls = []
    rounds = 0
    t0 = time.perf_counter()
    elapsed = 0.0
    while not calls or elapsed < seconds:
        chunks = max(1, math.ceil((seconds - elapsed) / pace))
        trainer.run(chunks * K, chunk=K)
        rounds += chunks * K
        elapsed = time.perf_counter() - t0
        calls.append(chunks)
        pace = elapsed * K / rounds
    rounds_per_s = rounds / elapsed
    rm = trainer.round_metrics
    attempted = rounds
    failed = sum(1 for a, b in zip(rm["loss"][-rounds:], rm["delta_norm"][-rounds:])
                 if not (math.isfinite(a) and math.isfinite(b)))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    _log(f"[bench] window: {rounds} rounds in {elapsed:.4f} s, {rounds_per_s:.4f} rounds/s, "
         f"peak {peak / 1e9:.3f} GB, failed {failed}; calls of {calls} chunks")
    _log(f"[bench] rounds' loss {rm['loss'][0]:.6g} first, {rm['loss'][-1]:.6g} last; the PS "
         f"delta's norm {rm['delta_norm'][0]:.6g} first, {max(rm['delta_norm']):.6g} largest")
    fenced = [c["seconds"] for c in trainer.meter.chunks[-(rounds // K):]]
    _log(f"[bench] the trainer's fenced chunks in the window, s: {[round(f, 4) for f in fenced]}")

    # the captured round holds the launches the traffic names (kernel 1
    # once a round), and is replayed once a round
    launches = stats.get("captured_launches")
    launches_ok = True
    if device.type == "cuda":
        launches_ok = launches == cell.round["captured_launches"]
        _log(f"[bench] launches in the captured round {launches}, warm-up "
             f"{stats.get('warmup_launches')}, replays {trainer._scan_fn.stats.get('replays')}")

    # -- the traced segment --------------------------------------------------
    view = None
    if trace:
        view = tracing.record(lambda: trainer.run(2 * K, chunk=K), 2, K, sync)
        view.stats = stats
        _log(f"[bench] traced {len(view.chunks)} chunks: {len(view.kernels)} kernels, "
             f"{len(view.graph_kernels())} of them the rounds' replays, "
             f"{len(view.copies)} copies and fills, {len(view.host_ops)} host ops; "
             f"window {view.window_s:.4f} s, busy {view.busy_s:.4f} s")
        view.cell = {"n_clients": config["protocol"]["n_clients"],
                     "d": cell.family.n_params(config),
                     "flops_per_round": cell.family.flops_per_round(config, traffic),
                     "peak_flops": hw.peak_flops(config["peak"]),
                     "rounds_per_s": rounds_per_s, "device": device.type}

    # -- the check, once the program's state is freed ------------------------
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readout(cell)
    numbers, correct, left_out = check.compare(prog, ref, limits)
    correct = correct and launches_ok and failed == 0
    _log(f"[bench] reference {time.perf_counter() - t_ref:.3f} s; leaves left out "
         f"{left_out}; the captured round's launches as named: {launches_ok}")

    result: Dict[str, Any] = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if rehearse:
        result["metrics"] = {}
        result["device"] = {"platform": "cpu", "kind": platform.machine() or "cpu", "count": 1}
        result["rehearsal"] = {"rounds": rounds, "seconds": elapsed, "calls": calls}
    else:
        if view is None:
            # a metric named ``<quantity>.<group>`` reports its quantity
            values = {"rounds_per_s": rounds_per_s, "peak_gb": peak / 1e9, "setup_s": setup_s}
            metrics = {}
            for m in reg.metrics(workload, "end_to_end"):
                metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
        else:
            metrics = _per_layer(reg, workload, view)
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": int(cell_entry["chips"]), "memory_peak_bytes": int(peak)}
        _log(f"[bench] card: {hw.power_limit()}")
    if view is not None and device.type == "cuda":
        result["device"]["busy_s"] = view.busy_s
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = tracing.breakdown(view)
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in numbers.items()}
    return result


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the cell at its rehearsal sizes on the CPU; no device metric")
    args = ap.parse_args(argv)
    reg = Registry()
    src = reg.root / "src"
    if not (src / "repro_torch").is_dir():
        _log(f"[bench] no program: {src / 'repro_torch'} is missing")
        return 2
    sys.path.insert(0, str(src))
    _cache_dirs(reg.root)
    import torch

    chips = int(reg.cell(args.workload)["chips"])
    if not args.rehearse and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        _log(f"[bench] the cell needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                      rehearse=args.rehearse)
    loaded = forbidden_loaded()
    if loaded:
        _log(f"[bench] refused: the process holds {loaded}")
        return 4
    _log(f"[bench] correct = {result['correct']}; the numbers compared, each with its limit:")
    for k, v in result["checks"].items():
        _log(f"[bench] check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0

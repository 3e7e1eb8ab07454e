"""Step builders for the model zoo, on one device or on a mesh.

The counterpart of ``repro.launch.steps.build_step`` (an input shape's
``kind``, see :data:`repro_torch.configs.base.INPUT_SHAPES`):

* ``train`` -> one full ColRel FL round of the model (T local SGD steps a
  client, the relay consensus, the blind PS sum, PS momentum) at the
  paper's hyperparameters, :data:`CLIENT_LR`, :data:`CLIENT_WD` and
  :data:`SERVER_MOMENTUM`: ``round(params, server_state, agg_state,
  batches, tau_up, tau_dd, A) -> (params, server_state, agg_state,
  metrics)`` from :mod:`repro_torch.fl.round`, the async round for an
  async strategy, the chunked engine (one round captured as a CUDA graph
  and replayed, on one device or on a mesh) under ``scan_rounds``, the
  instrumented round under ``telemetry``;
* ``prefill`` -> ``prefill_step(params, batch)``: the last-position logits
  ``(B, V)`` of the prompt.  On one device the forward runs with
  ``use_flash=True``: an encoder-decoder's and a hybrid's causal
  self-attention through the flash-attention kernel, a hybrid's Mamba
  layers through ``ssd_scan``; the decoder-only LMs take no kernel (every
  layer has a window, see :mod:`repro_torch.models.transformer`).  On a
  mesh it runs with the flag off, as the reference's does: the kernels
  take whole local tensors, not DTensors;
* ``decode`` -> ``serve_step(params, cache, token, pos)``: one-token
  decode against the KV cache, ``(logits (B, V), cache)``.

Two call forms:

* ``build_step(bundle, kind, n_clients=...)`` — the step alone, on one
  device;
* ``build_step(arch_id, shape_name, mesh, ...)`` — the reference's form:
  ``(step, args, in_shardings, out_shardings)``, the args as meta tensors
  (:func:`repro_torch.launch.specs.input_specs`) and the shardings as trees
  of :class:`~repro_torch.dist.NamedSharding` from
  :mod:`repro_torch.launch.sharding`.  The config gets the mesh's
  ``act_spec`` and ``moe_buf_spec``, the train round ``spmd_axes`` (the
  client axes, for ``per_client`` and ``weighted_grad``) and fsdp
  shardings (``client_sequential``, ``weighted_grad``, ``weighted_flat``).
  The step runs its body under ``use_mesh(mesh)`` with plain tensors taken
  as replicated; :func:`place` lays whole tensors out as DTensors by the
  in-shardings.  With ``mesh=None`` it is the one-device step with
  ``n_clients`` clients and no shardings.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_arch
from repro_torch.core import flatten
from repro_torch.dist.constraints import NamedSharding, use_mesh
from repro_torch.dist.layout import distribute, is_dtensor
from repro_torch.dist.mesh import client_axes, mesh_view, n_clients as mesh_clients
from repro_torch.fl.round import (
    RoundConfig,
    StrategySpec,
    make_async_round_fn,
    make_async_scan_round_fn,
    make_round_fn,
    make_scan_round_fn,
)
from repro_torch.launch import sharding as shard_rules
from repro_torch.launch.specs import DRYRUN_LOCAL_STEPS, input_specs, on_meta
from repro_torch.models import ModelConfig, build
from repro_torch.optim import sgd, sgd_momentum

__all__ = ["STEP_KINDS", "CLIENT_LR", "CLIENT_WD", "SERVER_MOMENTUM", "FSDP_MODES", "get_arch_cfg",
           "build_step", "train_state_shardings", "place"]

STEP_KINDS = ("train", "prefill", "decode")

# the paper's hyperparameters, carried into the round
CLIENT_LR = 0.05
CLIENT_WD = 1e-4
SERVER_MOMENTUM = 0.9

#: the round modes whose params are also sharded over the client axes
FSDP_MODES = ("client_sequential", "weighted_grad", "weighted_flat")


def get_arch_cfg(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    mod = get_arch(arch_id)
    return mod.smoke() if smoke else mod.full()


def build_step(bundle, kind, mesh=None, *, n_clients: Optional[int] = None,
               aggregation: StrategySpec = "colrel", fl_mode: Optional[str] = None,
               cfg_override: Optional[ModelConfig] = None, scan_rounds: Optional[int] = None,
               telemetry: bool = False):
    """The step of ``kind`` for the model ``bundle`` builds, or with an arch
    id and an input shape name (the reference's form) ``(step, args,
    in_shardings, out_shardings)`` on ``mesh``; see the module docstring.

    ``train`` takes the round's keywords: ``n_clients`` (required on one
    device; on a mesh its client axes' count by default, or a multiple of
    it, each rank then running several clients), ``aggregation`` (a registry name
    or strategy), ``fl_mode`` (default: the config's), ``scan_rounds`` (the
    chunked engine, whose K is the leading axis of the batches and taus it
    is given) and ``telemetry``.  ``cfg_override``
    replaces the arch's ``full()`` config in the reference's form.
    """
    if isinstance(bundle, str):
        return _build_for_shape(bundle, kind, mesh, n_clients=n_clients,
                                aggregation=aggregation, fl_mode=fl_mode,
                                cfg_override=cfg_override, scan_rounds=scan_rounds,
                                telemetry=telemetry)
    if kind == "train":
        if n_clients is None:
            raise ValueError("the train step needs n_clients")
        strategy = strategy_registry.resolve(aggregation)
        rc = RoundConfig(n_clients=int(n_clients), local_steps=DRYRUN_LOCAL_STEPS,
                         mode=fl_mode or bundle.cfg.fl_mode, aggregation=strategy)
        is_async = getattr(strategy, "is_async", False)
        if scan_rounds:
            make_fn = make_async_scan_round_fn if is_async else make_scan_round_fn
        else:
            make_fn = make_async_round_fn if is_async else make_round_fn
        return make_fn(bundle.loss_fn, sgd(CLIENT_LR, weight_decay=CLIENT_WD),
                       sgd_momentum(1.0, beta=SERVER_MOMENTUM), rc, telemetry=telemetry)
    if kind not in STEP_KINDS:
        raise ValueError(f"unknown step kind {kind!r}; known: {STEP_KINDS}")
    if bundle.forward is None or not bundle.has_decode:
        raise ValueError(f"{getattr(bundle.cfg, 'name', bundle.cfg)} has no serving path")
    if kind == "prefill":

        def prefill_step(params, batch):
            # serving prefill: last-position logits only, copied out so that
            # the (B, T, V) logits are freed
            return bundle.forward(params, batch, use_flash=True)[:, -1, :].contiguous()

        return prefill_step

    def serve_step(params, cache, token, pos):
        return bundle.decode_step(params, cache, token, pos)

    return serve_step


# ---------------------------------------------------------------------------
# the reference's form: (step, args, in_shardings, out_shardings) on a mesh
# ---------------------------------------------------------------------------


def _sharded_cfg(cfg: ModelConfig, kind: str, mode: str, shape: InputShape, mesh) -> ModelConfig:
    """``cfg`` with the mesh's residual-stream and MoE-buffer specs, as the
    reference's ``build_step`` sets them."""
    view = mesh_view(mesh)
    ca = client_axes(view)
    caxis = ca if len(ca) > 1 else ca[0]
    fsdp = mode in FSDP_MODES
    if cfg.n_experts > 0:  # expert-parallel dispatch buffers (every kind)
        if cfg.n_experts % view.shape["model"] == 0:
            cfg = cfg.replace(moe_buf_spec=("model", None, None))
        else:
            cfg = cfg.replace(moe_buf_spec=(None, "model", None))
    if kind == "train":
        B = shape.global_batch // mesh_clients(view)
        if mode == "weighted_flat":
            # the flat batch over the whole mesh at every block when it divides
            full = (*ca, "model")
            n_full = 1
            for a in full:
                n_full *= view.shape[a]
            if shape.global_batch % n_full == 0:
                return cfg.replace(act_spec=(full, None, None))
            return cfg.replace(act_spec=(caxis, "model", None))
        if fsdp and B % view.shape["model"] == 0:
            return cfg.replace(act_spec=("model", None, None))
        return cfg.replace(act_spec=(None, "model", None))
    if kind == "prefill" and (fsdp or cfg.n_experts == 0):
        # batch over the client axes, sequence over model (not for a
        # per_client MoE: sequence-sharded tokens fight its dispatch)
        return cfg.replace(act_spec=(caxis, "model", None))
    return cfg


def on_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` run under ``use_mesh(mesh)``, with plain tensors meeting
    DTensors as replicated ones; ``fn`` itself without a device mesh."""
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        return fn

    @functools.wraps(fn)
    def step(*args):
        from torch.distributed.tensor.experimental import implicit_replication

        with use_mesh(mesh), implicit_replication():
            return fn(*args)

    return step


def place(args: Any, shardings: Any) -> Any:
    """Whole tensors laid out by their shardings (each rank cuts its own
    chunk, no communication); anything else, and a leaf without a
    sharding, as it is."""
    if shardings is None:
        return args
    if isinstance(shardings, NamedSharding):
        plain = isinstance(args, torch.Tensor) and not is_dtensor(args)
        return distribute(args, shardings) if plain else args
    if isinstance(args, dict):
        return {k: place(v, shardings.get(k) if isinstance(shardings, dict) else None)
                for k, v in args.items()}
    if isinstance(args, (list, tuple)) and isinstance(shardings, (list, tuple)) \
            and len(args) == len(shardings):
        out = [place(a, s_) for a, s_ in zip(args, shardings)]
        return type(args)(out) if isinstance(args, tuple) else out
    return args


def _agg_state_spec(strategy, n: int, d: int) -> Any:
    return on_meta(strategy.init_state, n, d)


def train_state_shardings(arch_id: str, shape_name, mesh, *,
                          aggregation: StrategySpec = "colrel", fl_mode: Optional[str] = None,
                          cfg_override: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """The shardings of the checkpointable train-state leaves,
    ``{"params", "server_state", "agg_state"}``, matching
    :func:`build_step`'s train in/out shardings."""
    mode = fl_mode or (cfg_override or get_arch_cfg(arch_id)).fl_mode
    specs = input_specs(arch_id, shape_name, mesh, cfg=cfg_override, fl_mode=mode)
    cfg = specs["cfg"]
    fsdp = mode in FSDP_MODES
    strategy = strategy_registry.resolve(aggregation)
    C = mesh_clients(mesh)
    agg_state = _agg_state_spec(strategy, C, flatten.flat_spec(specs["params"]).d)
    return {
        "params": shard_rules.param_shardings(cfg, specs["params"], mesh, fsdp=fsdp),
        "server_state": shard_rules.param_shardings(cfg, specs["server_state"], mesh, fsdp=fsdp),
        "agg_state": shard_rules.client_state_shardings(mesh, agg_state, C),
    }


def _build_for_shape(arch_id: str, shape_name, mesh, *, n_clients, aggregation, fl_mode,
                     cfg_override, scan_rounds, telemetry) -> Tuple[Callable, tuple, Any, Any]:
    cfg0 = cfg_override or get_arch_cfg(arch_id)
    mode = fl_mode or cfg0.fl_mode
    if mesh is None:
        C = 16 if n_clients is None else int(n_clients)
    else:
        C = mesh_clients(mesh) if n_clients is None else int(n_clients)
        if C % mesh_clients(mesh):
            raise ValueError(f"{C} clients do not split over the mesh's {mesh_clients(mesh)}")
    specs = input_specs(arch_id, shape_name, C, cfg=cfg_override, fl_mode=mode)
    shape = shape_name if isinstance(shape_name, InputShape) else INPUT_SHAPES[shape_name]
    kind = specs["kind"]
    cfg = specs["cfg"] if mesh is None else _sharded_cfg(specs["cfg"], kind, mode, shape, mesh)
    specs["cfg"] = cfg
    bundle = build(cfg)
    fsdp = mode in FSDP_MODES
    psh = None if mesh is None else shard_rules.param_shardings(cfg, specs["params"], mesh,
                                                                fsdp=fsdp)
    rep = None if mesh is None else NamedSharding(mesh, ())
    ca = () if mesh is None else client_axes(mesh)

    if kind == "train":
        strategy = strategy_registry.resolve(aggregation)
        rc = RoundConfig(n_clients=C, local_steps=DRYRUN_LOCAL_STEPS, mode=mode,
                         aggregation=strategy,
                         spmd_axes=ca if ca and mode in ("per_client", "weighted_grad") else None,
                         unroll=getattr(cfg, "scan_unroll", False))
        is_async = getattr(strategy, "is_async", False)
        if scan_rounds:
            K = int(scan_rounds)
            make_fn = make_async_scan_round_fn if is_async else make_scan_round_fn
            specs["batches"] = tree.map(lambda t: t.new_empty((K, *t.shape)), specs["batches"])
            specs["tau_up"] = specs["tau_up"].new_empty((K, *specs["tau_up"].shape))
            specs["tau_dd"] = specs["tau_dd"].new_empty((K, *specs["tau_dd"].shape))
        else:
            make_fn = make_async_round_fn if is_async else make_round_fn
        # the gradients' layout matters only to the weighted modes, which
        # the sync rounds alone run (async strategies are per_client)
        extra = ({"grad_shardings": psh}
                 if fsdp and make_fn in (make_round_fn, make_scan_round_fn) else {})
        round_fn = make_fn(bundle.loss_fn, sgd(CLIENT_LR, weight_decay=CLIENT_WD),
                           sgd_momentum(1.0, beta=SERVER_MOMENTUM), rc, telemetry=telemetry,
                           **extra)
        agg_state = _agg_state_spec(strategy, C, flatten.flat_spec(specs["params"]).d)
        args = (specs["params"], specs["server_state"], agg_state, specs["batches"],
                specs["tau_up"], specs["tau_dd"], specs["A"])
        if telemetry:
            specs["streak"] = specs["tau_up"].new_empty((C,), dtype=torch.int32)
            args = (*args, specs["streak"])
        # the carry slots alias their outputs (params, server_state,
        # agg_state, and the telemetry streak)
        round_fn.donate_argnums = (0, 1, 2) + ((7,) if telemetry else ())
        if mesh is None:
            return round_fn, args, None, None
        ssh = shard_rules.param_shardings(cfg, specs["server_state"], mesh, fsdp=fsdp)
        st_sh = shard_rules.client_state_shardings(mesh, agg_state, C)
        bsh = shard_rules.train_batch_shardings(mesh, mode, specs["batches"],
                                                scan=bool(scan_rounds))
        tau_sh = shard_rules.fl_round_rule(scan=bool(scan_rounds)).shardings(
            mesh, {"tau_up": specs["tau_up"], "tau_dd": specs["tau_dd"]})
        A_sh = shard_rules.fl_round_rule().shardings(mesh, {"A": specs["A"]})["A"]
        in_sh = (psh, ssh, st_sh, bsh, tau_sh["tau_up"], tau_sh["tau_dd"], A_sh)
        metrics_sh = {k: rep for k in round_fn.metric_keys if k != "weight_drift"}
        out_sh = (psh, ssh, st_sh, metrics_sh)
        if telemetry:
            streak_sh = shard_rules.telemetry_rule().shardings(
                mesh, {"streak": specs["streak"]})["streak"]
            lead = (int(scan_rounds),) if scan_rounds else ()
            vec = {k: specs["tau_up"].new_empty((*lead, C)) for k in
                   ("client_participation", "client_uplink_bits", "outage_streak")}
            metrics_sh = dict(metrics_sh, weight_drift=rep,
                              **shard_rules.telemetry_rule(scan=bool(scan_rounds)).shardings(
                                  mesh, vec))
            in_sh = (*in_sh, streak_sh)
            out_sh = (psh, ssh, st_sh, streak_sh, metrics_sh)
        step = on_mesh(round_fn, mesh)
        step.donate_argnums = round_fn.donate_argnums
        return step, args, in_sh, out_sh

    one_device = build_step(bundle, kind) if mesh is None else None
    if kind == "prefill":
        if mesh is None:
            return one_device, (specs["params"], specs["batch"]), None, None

        def prefill_step(params, batch):
            # last-position logits only; the flash flag off (see the module)
            return bundle.forward(params, batch, use_flash=False)[:, -1, :]

        bsh = tree.map(lambda t: shard_rules.serve_batch_sharding(mesh, tuple(t.shape)),
                       specs["batch"])
        B = specs["batch"]["tokens"].shape[0]
        out_sh = NamedSharding(mesh, _logits_spec(cfg, mesh, B))
        return on_mesh(prefill_step, mesh), (specs["params"], specs["batch"]), (psh, bsh), out_sh

    args = (specs["params"], specs["cache"], specs["token"], specs["pos"])
    if mesh is None:
        return one_device, args, None, None
    if bundle.decode_step is None or not bundle.has_decode:
        raise ValueError(f"{getattr(cfg, 'name', cfg)} has no serving path")

    def serve_step(params, cache, token, pos):
        return bundle.decode_step(params, cache, token, pos)

    csh = shard_rules.cache_shardings(cfg, mesh, specs["cache"])
    tsh = shard_rules.serve_batch_sharding(mesh, tuple(specs["token"].shape))
    B = specs["token"].shape[0]
    out_sh = (NamedSharding(mesh, _logits_spec(cfg, mesh, B)), csh)
    return on_mesh(serve_step, mesh), args, (psh, csh, tsh, rep), out_sh


def _logits_spec(cfg: ModelConfig, mesh, B: int) -> tuple:
    """(B, V) logits: the vocabulary over ``model`` when it divides, the
    batch over the client axes when it divides."""
    view = mesh_view(mesh)
    ca = client_axes(view)
    spec = [None, "model" if cfg.vocab_size % view.shape["model"] == 0 else None]
    if B % mesh_clients(view) == 0 and B > 1:
        spec[0] = ca if len(ca) > 1 else ca[0]
    return tuple(spec)

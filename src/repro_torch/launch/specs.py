"""Shape-and-dtype stand-ins for every input of a step kind, on one device.

The counterpart of ``repro.launch.specs``.  The reference lowers against
``jax.ShapeDtypeStruct``s; here the stand-ins are tensors on
``torch.device("meta")``: shape and dtype, nothing allocated, whatever the
model's size.  There is no mesh: the caller gives ``n_clients``.

``input_specs(arch_id, shape_name, n_clients)`` returns a dict:

* train: ``params``, ``server_state``, ``batches``, ``tau_up``, ``tau_dd``,
  ``A`` (the FL round);
* prefill: ``params``, ``batch``;
* decode: ``params``, ``cache``, ``token``, ``pos``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_arch
from repro_torch.models import ModelConfig, build
from repro_torch.optim import sgd_momentum

__all__ = ["DRYRUN_LOCAL_STEPS", "on_meta", "params_spec", "input_specs"]

META = torch.device("meta")

DRYRUN_LOCAL_STEPS = 2  # T for the dry-run round (paper uses 8; FLOPs scale linearly)


class _AllOnMeta(TorchFunctionMode):
    """Every factory call's explicit ``device`` becomes the meta device (an
    init draws on its generator's device)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = META
        return func(*args, **kwargs)


def on_meta(fn: Callable, *args, **kwargs) -> Any:
    """``fn(*args, **kwargs)`` with every tensor it makes on the meta device:
    the shapes and dtypes of its result, with no storage and no compute
    (random fills are skipped on meta tensors)."""
    with META, _AllOnMeta():
        return fn(*args, **kwargs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def params_spec(bundle) -> Any:
    return on_meta(bundle.init, torch.Generator().manual_seed(0))


def _train_batch_spec(cfg: ModelConfig, n_clients: int, shape: InputShape,
                      mode: str) -> Dict[str, torch.Tensor]:
    S = shape.seq_len
    B = shape.global_batch // n_clients
    if B < 1:
        raise ValueError(f"{shape.name}: global batch {shape.global_batch} < {n_clients} clients")
    if mode == "weighted_flat":  # flat T = 1 round: (C*B, ...) batches
        lead = (shape.global_batch,)
    elif mode == "weighted_grad":  # T = 1 collapse: (C, B, ...) batches
        lead = (n_clients, B)
    else:
        lead = (n_clients, DRYRUN_LOCAL_STEPS, B)
    spec = {"tokens": _meta((*lead, S), torch.int32), "labels": _meta((*lead, S), torch.int32)}
    if cfg.frontend_tokens:
        spec["prefix"] = _meta((*lead, cfg.frontend_tokens, cfg.d_model), cfg.tdtype)
    return spec


def input_specs(arch_id: str, shape_name: Union[str, InputShape], n_clients: int,
                cfg: Optional[ModelConfig] = None,
                fl_mode: Optional[str] = None) -> Dict[str, Any]:
    """All inputs of one (arch x input-shape) combination, as meta tensors,
    under ``kind`` with the ``cfg`` they were made for.  ``shape_name`` is
    a name of ``INPUT_SHAPES`` or an :class:`InputShape` of its own."""
    if cfg is None:
        cfg = get_arch(arch_id).full()
    fl_mode = fl_mode or cfg.fl_mode
    bundle = build(cfg)
    shape = shape_name if isinstance(shape_name, InputShape) else INPUT_SHAPES[shape_name]
    C = int(n_clients)

    if shape.kind == "train":
        pspec = params_spec(bundle)
        return {
            "kind": "train",
            "cfg": cfg,
            "params": pspec,
            "server_state": on_meta(sgd_momentum(1.0, beta=0.9).init, pspec),
            "batches": _train_batch_spec(cfg, C, shape, fl_mode),
            "tau_up": _meta((C,), torch.float32),
            "tau_dd": _meta((C, C), torch.float32),
            "A": _meta((C, C), torch.float32),
        }

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
        if cfg.frontend_tokens:
            batch["prefix"] = _meta((B, cfg.frontend_tokens, cfg.d_model), cfg.tdtype)
        return {"kind": "prefill", "cfg": cfg, "params": params_spec(bundle), "batch": batch}

    # decode: one new token against a seq_len-deep cache
    if cfg.arch_type in ("encdec", "audio"):
        cache = on_meta(bundle.init_cache, B, S, cfg.frontend_tokens)
    else:
        cache = on_meta(bundle.init_cache, B, S)
    return {
        "kind": "decode",
        "cfg": cfg,
        "params": params_spec(bundle),
        "cache": cache,
        "token": _meta((B, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }

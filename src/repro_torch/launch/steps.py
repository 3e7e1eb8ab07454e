"""Step builders for the model zoo, on one device.

The counterpart of ``repro.launch.steps.build_step`` (an input shape's
``kind``, see :data:`repro_torch.configs.base.INPUT_SHAPES`):

* ``train`` -> one full ColRel FL round of the model (T local SGD steps a
  client, the relay consensus, the blind PS sum, PS momentum) at the
  paper's hyperparameters, :data:`CLIENT_LR`, :data:`CLIENT_WD` and
  :data:`SERVER_MOMENTUM`: ``round(params, server_state, agg_state,
  batches, tau_up, tau_dd, A) -> (params, server_state, agg_state,
  metrics)`` from :mod:`repro_torch.fl.round`, the async round for an
  async strategy, the chunked engine (one round captured as a CUDA graph
  and replayed) under ``scan_rounds``, the instrumented round under
  ``telemetry``;
* ``prefill`` -> ``prefill_step(params, batch)``: the last-position logits
  ``(B, V)`` of the prompt, the forward run with ``use_flash=True``: an
  encoder-decoder's and a hybrid's causal self-attention through the
  flash-attention kernel, a hybrid's Mamba layers through ``ssd_scan``;
  the decoder-only LMs take no kernel (every layer has a window, see
  :mod:`repro_torch.models.transformer`);
* ``decode`` -> ``serve_step(params, cache, token, pos)``: one-token
  decode against the KV cache, ``(logits (B, V), cache)``.

No sharding: one device holds the params, the batch and the cache, so
the reference's sharding rules, meshes and donation indices have no
counterpart here; the inputs' shapes are :func:`repro_torch.launch.specs.input_specs`.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch import strategies as strategy_registry
from repro_torch.configs.base import get_arch
from repro_torch.fl.round import (
    RoundConfig,
    StrategySpec,
    make_async_round_fn,
    make_async_scan_round_fn,
    make_round_fn,
    make_scan_round_fn,
)
from repro_torch.launch.specs import DRYRUN_LOCAL_STEPS
from repro_torch.models import ModelBundle, ModelConfig
from repro_torch.optim import sgd, sgd_momentum

__all__ = ["STEP_KINDS", "CLIENT_LR", "CLIENT_WD", "SERVER_MOMENTUM", "get_arch_cfg",
           "build_step"]

STEP_KINDS = ("train", "prefill", "decode")

# the paper's hyperparameters, carried into the round
CLIENT_LR = 0.05
CLIENT_WD = 1e-4
SERVER_MOMENTUM = 0.9


def get_arch_cfg(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    mod = get_arch(arch_id)
    return mod.smoke() if smoke else mod.full()


def build_step(bundle: ModelBundle, kind: str, *, n_clients: Optional[int] = None,
               aggregation: StrategySpec = "colrel", fl_mode: Optional[str] = None,
               scan_rounds: Optional[int] = None, telemetry: bool = False) -> Callable:
    """The step function of ``kind`` for the model ``bundle`` builds.

    ``train`` takes the round's keywords: ``n_clients`` (required),
    ``aggregation`` (a registry name or strategy), ``fl_mode`` (default:
    the config's), ``scan_rounds`` (the chunked engine, whose K is the
    leading axis of the batches and taus it is given) and ``telemetry``.
    """
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

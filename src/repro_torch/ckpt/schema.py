"""The versioned run-state schema.

The port of ``repro.ckpt.schema``.  One checkpoint is one tree holding
everything a training run carries across rounds, so a restore continues
bitwise:

================  ==========================================================
key               contents
================  ==========================================================
``version``       schema version (:data:`CKPT_VERSION`)
``round``         the trainer's round counter
``strategy``      registry name (checked on restore)
``params``        model parameters
``server_state``  PS optimizer state
``agg_state``     the strategy's carried state through its
                  ``checkpoint_state``/``restore_state`` hooks (the memory
                  buffer, the async age vector and staging buffer, the
                  codecs' generators as tagged dicts)
``A``             the live relay-weight matrix (the adaptive schedule swaps it)
``streak``        the telemetry outage-streak carry (None with telemetry off)
``clients``       the clients' data streams (JSON of each numpy
                  ``bit_generator.state``) at the consumed-round boundary: the
                  chunked engine stacks the next chunk's batches before the
                  checkpoint point, so the trainer records them before that
``channel``       the channel's generator state via its
                  ``checkpoint_state``/``restore_state`` (a restore
                  regenerates the current block bitwise)
``no_trace``      the in-scan sampler's carry ``{state, gen}`` (None unless the
                  run used ``no_trace=True``)
``adaptive``      the estimator's posterior and the re-opt event log (None
                  without a schedule)
``metrics``       the ``MetricsLogger``'s ``seq`` cursor, TrainLog facade,
                  ``round_metrics`` and vector histories
================  ==========================================================

Nothing here imports the trainer: capture and restore work on any object
with ``FLTrainer``'s state attributes.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt.keys import decode_generator, encode_generator

__all__ = ["CKPT_VERSION", "capture_run_state", "restore_run_state",
           "rng_state_to_json", "rng_from_json"]

CKPT_VERSION = 1


def rng_state_to_json(rng: np.random.Generator) -> str:
    """A numpy Generator's full state as a JSON string (JSON holds PCG64's
    128-bit ints exactly)."""
    return json.dumps(rng.bit_generator.state)


def rng_from_json(s: str) -> np.random.Generator:
    """Rebuild a Generator mid-stream from :func:`rng_state_to_json`."""
    state = json.loads(s)
    rng = np.random.default_rng()
    if rng.bit_generator.state["bit_generator"] != state["bit_generator"]:
        raise ValueError(
            f"checkpointed RNG is a {state['bit_generator']}, default_rng "
            f"builds a {rng.bit_generator.state['bit_generator']}")
    rng.bit_generator.state = state
    return rng


def capture_run_state(trainer) -> Dict[str, Any]:
    """A trainer's complete run state as one checkpointable tree (its
    tensors are copied by the writer's ``snapshot``)."""
    no_trace = None
    if trainer._channel_gen is not None:
        no_trace = {"state": trainer._channel_state,
                    "gen": encode_generator(trainer._channel_gen)}
    return {
        "version": CKPT_VERSION,
        "round": int(trainer.round),
        "strategy": trainer.strategy.name,
        "params": trainer.params,
        "server_state": trainer.server_state,
        "agg_state": trainer.strategy.checkpoint_state(trainer.agg_state),
        "A": trainer.A,
        "streak": trainer._streak,
        "clients": trainer._client_rng_states(),
        "channel": trainer.channel.checkpoint_state(),
        "no_trace": no_trace,
        "adaptive": (trainer.adaptive.checkpoint_state()
                     if trainer.adaptive is not None else None),
        "metrics": trainer.metrics.checkpoint_state(),
    }


def restore_run_state(trainer, state: Dict[str, Any]) -> None:
    """Reinstate a captured state onto a trainer assembled like the
    checkpointed one (same strategy, channel kind, client count, telemetry
    flag): the checkpoint carries state, not configuration, and a mismatch
    raises.  Generators are written into the trainer's existing ones where
    it has them, so a round it has already captured keeps its graph."""
    version = state.get("version")
    if version != CKPT_VERSION:
        raise ValueError(f"checkpoint schema version {version!r} != {CKPT_VERSION}")
    if state["strategy"] != trainer.strategy.name:
        raise ValueError(f"checkpoint was written by strategy {state['strategy']!r}; "
                         f"this trainer runs {trainer.strategy.name!r}")
    if (state.get("streak") is not None) != bool(trainer.telemetry):
        raise ValueError(
            "telemetry mismatch: checkpoint "
            f"{'has' if state.get('streak') is not None else 'lacks'} a "
            "streak carry but the trainer's telemetry flag disagrees")
    clients = state["clients"]
    if len(clients) != len(trainer.clients):
        raise ValueError(f"checkpoint has {len(clients)} client RNG streams; trainer "
                         f"has {len(trainer.clients)} clients")
    if state.get("adaptive") is not None and trainer.adaptive is None:
        raise ValueError("checkpoint carries adaptive-schedule state but the trainer "
                         "has no schedule attached")
    dev = trainer.device

    def on_device(x):
        return tree.map(lambda t: torch.as_tensor(t).to(dev), x)

    trainer.channel.restore_state(state["channel"])
    trainer.params = on_device(state["params"])
    trainer.server_state = on_device(state["server_state"])
    trainer.agg_state = trainer.strategy.restore_state(
        state["agg_state"], device=dev, like=trainer.agg_state)
    trainer.A = torch.as_tensor(state["A"], dtype=torch.float32).to(dev)
    trainer.round = int(state["round"])
    if state.get("streak") is not None:
        trainer._streak = torch.as_tensor(state["streak"], dtype=torch.int32).to(dev)
    for c, s in zip(trainer.clients, clients):
        c._rng = rng_from_json(s)
    trainer._data_rng_snapshot = None
    no_trace = state.get("no_trace")
    if no_trace is not None:
        trainer._channel_state = on_device(no_trace["state"])
        trainer._channel_gen = decode_generator(no_trace["gen"], into=trainer._channel_gen,
                                                device=dev)
    if state.get("adaptive") is not None:
        trainer.adaptive.restore_state(state["adaptive"])
    trainer.metrics.restore_state(state["metrics"])

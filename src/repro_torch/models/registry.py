"""Uniform model interface over the ported architecture families.

The counterpart of ``repro.models.registry``: ``build(cfg)`` returns a
:class:`ModelBundle` exposing

* ``init(generator) -> params``, on the generator's device;
* ``loss_fn(params, batch) -> (loss, metrics)``;
* ``forward(params, batch, *, use_flash=False) -> logits`` (prefill);
* ``init_cache(batch, max_len, memory_len) -> cache`` and
  ``decode_step(params, cache, token, pos) -> (logits, cache)``.

Every family of the reference: the paper's CNN
(:class:`~repro_torch.models.cnn.CNNConfig`), the encoder-decoder
(``arch_type`` ``encdec``/``audio``), the Mamba/attention hybrid
(``hybrid``, with or without MoE MLPs) and the generic decoder-only LM
(``dense``, ``moe``, ``ssm`` (RWKV6) and ``vlm``).  The hybrid and the
LM take ``init_cache(batch, max_len, device=None)``.  Another ``arch_type``
raises :class:`ValueError`.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

from repro_torch.models import cnn as cnn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import transformer as tr_mod
from repro_torch.models.common import ModelConfig

__all__ = ["ModelBundle", "build"]

# the families the generic decoder-only LM serves
_LM_FAMILIES = ("dense", "moe", "ssm", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    init: Callable  # (generator) -> params
    loss_fn: Callable  # (params, batch, *, use_flash=False) -> (loss, metrics)
    forward: Optional[Callable] = None  # (params, batch, *, use_flash=False) -> logits
    init_cache: Optional[Callable] = None  # (batch, max_len[, memory_len], device=None) -> cache
    decode_step: Optional[Callable] = None  # (params, cache, token, pos) -> (logits, cache)
    has_decode: bool = True


def build(cfg) -> ModelBundle:
    if isinstance(cfg, cnn_mod.CNNConfig):
        model = cnn_mod.CNN(cfg)  # a template: loss_fn runs it with the params it is given

        def init_cnn(generator):
            return cnn_mod.CNN(cfg, generator=generator).param_tree()

        return ModelBundle(
            cfg=cfg,
            init=init_cnn,
            loss_fn=lambda params, batch, **kw: cnn_mod.loss_fn(model, params, batch),
            has_decode=False,
        )
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"build takes a ModelConfig or CNNConfig, got {type(cfg).__name__}")
    if cfg.arch_type in ("encdec", "audio"):

        def _encdec_forward(params, batch, **kw):
            memory = encdec_mod.encode(cfg, params, batch["prefix"], **kw)
            return encdec_mod.decode_train(cfg, params, batch["tokens"], memory, **kw)

        return ModelBundle(
            cfg=cfg,
            init=partial(encdec_mod.init_encdec, cfg),
            loss_fn=partial(encdec_mod.loss_fn, cfg),
            forward=_encdec_forward,
            init_cache=partial(encdec_mod.init_cache, cfg),
            decode_step=partial(encdec_mod.decode_step, cfg),
        )
    if cfg.arch_type == "hybrid":
        hybrid_mod.n_periods(cfg)  # raises for ragged periods
        return ModelBundle(
            cfg=cfg,
            init=partial(hybrid_mod.init_hybrid, cfg),
            loss_fn=partial(hybrid_mod.loss_fn, cfg),
            forward=lambda params, batch, **kw: hybrid_mod.forward(
                cfg, params, batch["tokens"], **kw)[0],
            init_cache=partial(hybrid_mod.init_cache, cfg),
            decode_step=partial(hybrid_mod.decode_step, cfg),
        )
    if cfg.arch_type not in _LM_FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")
    return ModelBundle(
        cfg=cfg,
        init=partial(tr_mod.init_lm, cfg),
        loss_fn=partial(tr_mod.loss_fn, cfg),
        forward=lambda params, batch, **kw: tr_mod.forward(
            cfg, params, batch["tokens"], prefix_embeds=batch.get("prefix"), **kw)[0],
        init_cache=partial(tr_mod.init_cache, cfg),
        decode_step=partial(tr_mod.decode_step, cfg),
    )

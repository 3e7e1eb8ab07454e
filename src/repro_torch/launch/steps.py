"""Step builders for the model zoo, on one device.

The counterpart of the serving kinds of ``repro.launch.steps.build_step``
(an input shape's ``kind``, see :data:`repro_torch.configs.base.INPUT_SHAPES`):

* ``prefill`` -> ``prefill_step(params, batch)``: the last-position logits
  ``(B, V)`` of the prompt, the forward run with ``use_flash=True``: an
  encoder-decoder's and a hybrid's causal self-attention through the
  flash-attention kernel, a hybrid's Mamba layers through ``ssd_scan``;
  the decoder-only LMs take no kernel (every layer has a window, see
  :mod:`repro_torch.models.transformer`);
* ``decode`` -> ``serve_step(params, cache, token, pos)``: one-token
  decode against the KV cache, ``(logits (B, V), cache)``.

No sharding: one device holds the params, the batch and the cache.  The
``train`` kind (one FL round of a zoo model) is not ported: ROADMAP.md
queue 1, item 16.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import get_arch
from repro_torch.models import ModelBundle, ModelConfig

__all__ = ["STEP_KINDS", "get_arch_cfg", "build_step"]

STEP_KINDS = ("train", "prefill", "decode")


def get_arch_cfg(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    mod = get_arch(arch_id)
    return mod.smoke() if smoke else mod.full()


def build_step(bundle: ModelBundle, kind: str) -> Callable:
    """The step function of ``kind`` for the model ``bundle`` serves."""
    if kind == "train":
        raise NotImplementedError(
            "the train step of the model zoo is not ported to repro_torch yet: ROADMAP.md "
            "queue 1, item 16 (launch/train.py)")
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

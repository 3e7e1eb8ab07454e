"""Decoder-only language model assembly (dense / MoE / RWKV / VLM backbone).

The counterpart of ``repro.models.transformer``.  Layers are stored
stacked along a leading axis, under the reference's key paths, and run in
a Python loop (the reference scans them).  gemma3's 5 local : 1 global
sliding-window pattern is a per-layer window: global layers get
:data:`GLOBAL_WINDOW`, larger than any sequence.

Every layer passes its window to attention, so no layer takes the
flash-attention branch (it is taken only without a window): ``use_flash``
changes nothing here, as in the reference, whose scan passes a traced
window array.  The reference's sharding hint (``constrain_act``) and remat
are training-time and multi-device matters and are left out.

:func:`decode_step` writes the KV slots, or the RWKV shift and wkv
states, of the cache it is given in place, and returns that same cache.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (
    ModelConfig,
    Params,
    apply_norm,
    dense_init,
    embed_init,
    embed_tokens,
    init_norm,
    layer_at,
    lm_head,
    masked_lm_loss,
    stack_layers,
    unstack_layers,
)

__all__ = ["GLOBAL_WINDOW", "window_array", "init_lm", "forward", "loss_fn", "init_cache",
           "decode_step"]

GLOBAL_WINDOW = 1 << 30  # the window of a layer without a sliding window


def window_array(cfg: ModelConfig) -> List[int]:
    """Each layer's attention window."""
    if cfg.sliding_window is None:
        return [GLOBAL_WINDOW] * cfg.n_layers
    if not cfg.local_global_ratio:
        return [cfg.sliding_window] * cfg.n_layers
    period = cfg.local_global_ratio + 1
    return [GLOBAL_WINDOW if l % period == cfg.local_global_ratio else cfg.sliding_window
            for l in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dev = gen.device
    if cfg.arch_type == "ssm":  # rwkv6
        return {
            "ln1": init_norm(cfg, cfg.d_model, dev),
            "tm": rwkv_mod.init_rwkv_time_mix(cfg, gen),
            "ln2": init_norm(cfg, cfg.d_model, dev),
            "cm": rwkv_mod.init_rwkv_channel_mix(cfg, gen),
        }
    return {
        "ln1": init_norm(cfg, cfg.d_model, dev),
        "attn": attn_mod.init_attention(cfg, gen),
        "ln2": init_norm(cfg, cfg.d_model, dev),
        "ffn": (moe_mod.init_moe(cfg, gen) if cfg.n_experts > 0 else mlp_mod.init_mlp(cfg, gen)),
    }


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Params on ``gen``'s device, drawn from ``gen``; the layers stacked on
    a leading axis (the reference vmaps their init)."""
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.tdtype),
        "layers": stack_layers([_init_block(cfg, gen) for _ in range(cfg.n_layers)]),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.tdtype)
    if cfg.arch_type == "vlm" or cfg.frontend_tokens:
        params["proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), cfg.tdtype)
    return params


# ---------------------------------------------------------------------------
# Forward (teacher-forced / prefill)
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int, use_flash: bool,
           static_window: Optional[int] = None):
    """One layer -> (x, MoE aux)."""
    if cfg.arch_type == "ssm":
        h, _ = rwkv_mod.time_mix(cfg, lp["tm"], apply_norm(cfg, lp["ln1"], x))
        x = x + h
        h, _ = rwkv_mod.channel_mix(cfg, lp["cm"], apply_norm(cfg, lp["ln2"], x))
        return x + h, None
    h = attn_mod.attention(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x), window=window,
                           static_window=static_window, use_flash=use_flash)
    x = x + h
    hn = apply_norm(cfg, lp["ln2"], x)
    if cfg.n_experts > 0:
        h, aux = moe_mod.apply_moe(cfg, lp["ffn"], hn)
        return x + h, aux
    return x + mlp_mod.apply_mlp(cfg, lp["ffn"], hn), None


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            use_flash: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T) -> (logits (B, P + T, V), f32 MoE aux summed over the
    layers); ``prefix_embeds`` (B, P, d) (a VLM's patches) go through
    ``proj`` in front of the tokens."""
    x = embed_tokens(params, tokens)
    if prefix_embeds is not None:
        pref = prefix_embeds.to(x.dtype) @ params["proj"]
        x = torch.cat([pref, x], dim=1)
    wins = window_array(cfg)
    static = cfg.static_window_pattern and cfg.sliding_window is not None
    period = (cfg.local_global_ratio or 0) + 1
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, lp in enumerate(unstack_layers(params["layers"])):
        sw = None
        if static:  # the unrolled stack: local layers banded, global ones dense
            is_global = cfg.local_global_ratio and l % period == cfg.local_global_ratio
            sw = None if is_global else cfg.sliding_window
        x, a = _block(cfg, lp, x, wins[l], use_flash, static_window=sw)
        if a is not None:
            aux = aux + a
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ lm_head(cfg, params), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, use_flash: bool = False):
    """batch: 'tokens' (B, T), 'labels' (B, T) (negative labels are
    masked); optional 'prefix' (B, P, d) frontend embeddings and
    per-sequence 'ce_weight'."""
    logits, aux = forward(cfg, params, batch["tokens"], prefix_embeds=batch.get("prefix"),
                          use_flash=use_flash)
    logits = logits[:, -batch["labels"].shape[1]:]  # drop the prefix positions
    loss = masked_lm_loss(logits, batch)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode (one-token serve step against a preallocated cache)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    """The KV cache of every layer, or RWKV's states: each layer's its own
    zeros (the decode step writes them in place)."""
    if cfg.arch_type == "ssm":
        return tree.map(lambda x: x.expand(cfg.n_layers, *x.shape).clone(),
                        rwkv_mod.init_rwkv_state(cfg, batch, device=device))
    return attn_mod.init_kv_cache(cfg, batch, max_len, layers_shape=(cfg.n_layers,),
                                  device=device)


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token: torch.Tensor, pos):
    """token (B, 1) at position ``pos`` -> (logits (B, V), cache), the
    cache written in place."""
    x = embed_tokens(params, token)
    wins = window_array(cfg)
    for l in range(cfg.n_layers):
        lp, st = layer_at(params["layers"], l), layer_at(cache, l)  # st: views of the cache
        if cfg.arch_type == "ssm":
            h, tm = rwkv_mod.time_mix(cfg, lp["tm"], apply_norm(cfg, lp["ln1"], x),
                                      state=st["tm"])
            x = x + h
            h, cm = rwkv_mod.channel_mix(cfg, lp["cm"], apply_norm(cfg, lp["ln2"], x),
                                         state=st["cm"])
            x = x + h
            st["tm"]["shift"].copy_(tm["shift"])
            st["tm"]["wkv"].copy_(tm["wkv"])
            st["cm"].copy_(cm)
            continue
        h, _ = attn_mod.decode_attention(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x), st,
                                         pos, window=wins[l])
        x = x + h
        hn = apply_norm(cfg, lp["ln2"], x)
        if cfg.n_experts > 0:
            h, _ = moe_mod.apply_moe(cfg, lp["ffn"], hn)
        else:
            h = mlp_mod.apply_mlp(cfg, lp["ffn"], hn)
        x = x + h
    x = apply_norm(cfg, params["final_norm"], x)
    return (x @ lm_head(cfg, params))[:, 0], cache

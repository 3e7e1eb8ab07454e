"""Jamba-style hybrid: Mamba + attention 1:7 interleave with MoE MLPs.

The counterpart of ``repro.models.hybrid``.  Layer pattern per period of
``attn_every`` (= 8) layers: position 0 is a grouped-query attention
mixer, positions 1..7 are Mamba (SSD) mixers.  Every ``moe_every``-th
layer (= 2: the odd positions) carries a MoE MLP
(:mod:`repro_torch.models.moe`), the others a dense SwiGLU; ``moe_every=0``
gives every layer the dense MLP.  The params keep the reference's tree,
with a leading period axis on every leaf; the model loops over the
periods in Python (the reference scans them).  Each period's input and
each mixer's and MLP's output pass the ``constrain_act`` hook
(:mod:`repro_torch.dist`), the identity outside a mesh.

Under ``use_flash`` the forward's mixers go through the hand-written
kernels: the attention layer through flash attention, the Mamba layers
through ``ssd_scan`` (see :mod:`repro_torch.models.mamba`); without it,
through their plain versions.
:func:`decode_step` writes the KV cache and the Mamba states of the cache
it is given in place, and returns that same cache.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.dist.constraints import constrain_act
from repro_torch.dist.layout import merge_ready
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (
    ModelConfig,
    Params,
    apply_norm,
    dense_init,
    embed_init,
    embed_tokens,
    gathered,
    init_norm,
    layer_at,
    lm_head,
    masked_lm_loss,
    stack_layers,
    unstack_layers,
)

__all__ = ["n_periods", "init_hybrid", "forward", "loss_fn", "init_cache", "decode_step"]


def _pattern(cfg: ModelConfig):
    """Static layer pattern within one period: (period, attention
    positions, Mamba positions, MoE positions)."""
    period = cfg.attn_every
    if period < 1:
        raise ValueError(f"a hybrid needs attn_every >= 1, got {period}")
    moe_pos = [j for j in range(period) if cfg.moe_every and j % cfg.moe_every == 1]
    return period, [0], list(range(1, period)), moe_pos


def n_periods(cfg: ModelConfig) -> int:
    period = _pattern(cfg)[0]
    if cfg.n_layers % period:
        raise ValueError(f"n_layers={cfg.n_layers} is not a whole number of periods of {period}")
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_period(cfg: ModelConfig, gen: torch.Generator) -> Params:
    period, attn_pos, _, moe_pos = _pattern(cfg)
    p: Params = {"mixers": {}, "ffns": {}, "norms1": {}, "norms2": {}}
    for j in range(period):
        p["norms1"][f"l{j}"] = init_norm(cfg, cfg.d_model, gen.device)
        p["norms2"][f"l{j}"] = init_norm(cfg, cfg.d_model, gen.device)
        p["mixers"][f"l{j}"] = (attn_mod.init_attention(cfg, gen) if j in attn_pos
                                else mamba_mod.init_mamba(cfg, gen))
        p["ffns"][f"l{j}"] = (moe_mod.init_moe(cfg, gen) if j in moe_pos
                              else mlp_mod.init_mlp(cfg, gen))
    return p


def init_hybrid(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Params on ``gen``'s device, drawn from ``gen``; the periods stacked
    on a leading axis (the reference vmaps their init)."""
    periods = stack_layers([_init_period(cfg, gen) for _ in range(n_periods(cfg))])
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.tdtype),
        "periods": periods,
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.tdtype)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, moe: bool):
    """The layer's MLP -> (out, MoE aux or None)."""
    if moe:
        return moe_mod.apply_moe(cfg, p, x)
    return mlp_mod.apply_mlp(cfg, p, x), None


def _period_fwd(cfg: ModelConfig, pp: Params, x: torch.Tensor, use_flash: bool):
    x = constrain_act(cfg, x)
    period, attn_pos, _, moe_pos = _pattern(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(period):
        xn = apply_norm(cfg, pp["norms1"][f"l{j}"], x)
        if j in attn_pos:
            h = attn_mod.attention(cfg, pp["mixers"][f"l{j}"], xn, use_flash=use_flash)
        else:
            h, _ = mamba_mod.mamba_forward(cfg, pp["mixers"][f"l{j}"], xn, ssd_kernel=use_flash)
        # on a mesh each branch's output pinned to act_spec (see
        # repro_torch.models.transformer._block)
        x = x + constrain_act(cfg, h)
        h, a = _ffn(cfg, pp["ffns"][f"l{j}"], apply_norm(cfg, pp["norms2"][f"l{j}"], x),
                    j in moe_pos)
        x = x + constrain_act(cfg, h)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *, use_flash: bool = False):
    """tokens (B, T) -> (logits (B, T, V), f32 MoE aux loss).  ``use_flash``
    runs the attention layers through the flash-attention kernel and the
    Mamba layers' SSD through ``ssd_scan``; without it, both take their
    plain versions (the reference's attention path, ``ssd_scan_plain``)."""
    x = embed_tokens(params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pp in map(gathered, unstack_layers(params["periods"])):
        x, a = _period_fwd(cfg, pp, x, use_flash)
        aux = aux + a
    x = merge_ready(apply_norm(cfg, gathered(params["final_norm"]), x))
    return x @ lm_head(cfg, params), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, use_flash: bool = False):
    """batch: 'tokens' (B, T), 'labels' (B, T) (negative labels are
    masked); optional per-sequence 'ce_weight'."""
    logits, aux = forward(cfg, params, batch["tokens"], use_flash=use_flash)
    loss = masked_lm_loss(logits, batch)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    """Per period: one attention KV cache and the states of its Mamba
    layers, stacked over periods."""
    mamba_pos = _pattern(cfg)[2]
    NP = n_periods(cfg)
    kv = attn_mod.init_kv_cache(cfg, batch, max_len, layers_shape=(NP,), device=device)
    ms = mamba_mod.init_mamba_state(cfg, batch, device=device)
    mamba = tree.map(lambda x: x.expand(NP, len(mamba_pos), *x.shape).clone(), ms)
    return {"kv": kv, "mamba": mamba}


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token: torch.Tensor, pos):
    """token (B, 1) at position ``pos`` -> (logits (B, V), cache), the
    cache's KV slots and Mamba states written in place."""
    period, attn_pos, mamba_pos, moe_pos = _pattern(cfg)
    x = embed_tokens(params, token)
    for i in range(n_periods(cfg)):
        # kv: views of the cache
        pp, kv = gathered(layer_at(params["periods"], i)), layer_at(cache["kv"], i)
        for j in range(period):
            xn = apply_norm(cfg, pp["norms1"][f"l{j}"], x)
            if j in attn_pos:
                h, _ = attn_mod.decode_attention(cfg, pp["mixers"][f"l{j}"], xn, kv, pos)
            else:
                slot = layer_at(layer_at(cache["mamba"], i), mamba_pos.index(j))
                h, st = mamba_mod.mamba_step(cfg, pp["mixers"][f"l{j}"], xn, slot)
                for key in ("ssm", "conv"):
                    slot[key].copy_(st[key])
            x = x + h
            h, _ = _ffn(cfg, pp["ffns"][f"l{j}"], apply_norm(cfg, pp["norms2"][f"l{j}"], x),
                        j in moe_pos)
            x = x + h
    x = apply_norm(cfg, gathered(params["final_norm"]), x)
    return (x @ lm_head(cfg, params))[:, 0], cache

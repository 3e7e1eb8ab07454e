"""Jamba-style hybrid: Mamba + attention 1:7 interleave.

The counterpart of ``repro.models.hybrid``.  Layer pattern per period of
``attn_every`` (= 8) layers: position 0 is a grouped-query attention
mixer, positions 1..7 are Mamba (SSD) mixers, and every layer ends in an
MLP.  The params keep the reference's tree, with a leading period axis on
every leaf; the model loops over the periods in Python (the reference
scans them), and the reference's ``constrain_act`` sharding hint, a no-op
on one device, is left out.

Only dense MLPs are ported: the reference's MoE MLP on every
``moe_every``-th layer waits for ``models/moe.py``, so a config with MoE
positions (``moe_every > 0``) raises :class:`NotImplementedError`.

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
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    Params,
    apply_norm,
    dense_init,
    embed_init,
    init_norm,
    softmax_cross_entropy,
    stack_layers,
)

__all__ = ["n_periods", "init_hybrid", "forward", "loss_fn", "init_cache", "decode_step"]


def _pattern(cfg: ModelConfig):
    """Static layer pattern within one period: (period, attention
    positions, Mamba positions)."""
    period = cfg.attn_every
    if period < 1:
        raise ValueError(f"a hybrid needs attn_every >= 1, got {period}")
    if cfg.moe_every:
        moe_pos = [j for j in range(period) if j % cfg.moe_every == 1]
        raise NotImplementedError(
            f"{cfg.name}: MoE MLPs at period positions {moe_pos} (moe_every={cfg.moe_every}) "
            "are not ported to repro_torch yet: ROADMAP.md queue 1, item 17, step 2 "
            "(models/moe.py); moe_every=0 gives every layer the dense MLP")
    return period, [0], list(range(1, period))


def n_periods(cfg: ModelConfig) -> int:
    period = _pattern(cfg)[0]
    if cfg.n_layers % period:
        raise ValueError(f"n_layers={cfg.n_layers} is not a whole number of periods of {period}")
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_period(cfg: ModelConfig, gen: torch.Generator) -> Params:
    period, attn_pos, _ = _pattern(cfg)
    p: Params = {"mixers": {}, "ffns": {}, "norms1": {}, "norms2": {}}
    for j in range(period):
        p["norms1"][f"l{j}"] = init_norm(cfg, cfg.d_model, gen.device)
        p["norms2"][f"l{j}"] = init_norm(cfg, cfg.d_model, gen.device)
        p["mixers"][f"l{j}"] = (attn_mod.init_attention(cfg, gen) if j in attn_pos
                                else mamba_mod.init_mamba(cfg, gen))
        p["ffns"][f"l{j}"] = mlp_mod.init_mlp(cfg, gen)
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


def _layer(stacked: Params, i: int) -> Params:
    return tree.map(lambda x: x[i], stacked)


def _head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _period_fwd(cfg: ModelConfig, pp: Params, x: torch.Tensor, use_flash: bool) -> torch.Tensor:
    period, attn_pos, _ = _pattern(cfg)
    for j in range(period):
        xn = apply_norm(cfg, pp["norms1"][f"l{j}"], x)
        if j in attn_pos:
            h = attn_mod.attention(cfg, pp["mixers"][f"l{j}"], xn, use_flash=use_flash)
        else:
            h, _ = mamba_mod.mamba_forward(cfg, pp["mixers"][f"l{j}"], xn, ssd_kernel=use_flash)
        x = x + h
        xn = apply_norm(cfg, pp["norms2"][f"l{j}"], x)
        x = x + mlp_mod.apply_mlp(cfg, pp["ffns"][f"l{j}"], xn)
    return x


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *, use_flash: bool = False):
    """tokens (B, T) -> (logits (B, T, V), MoE aux loss 0).  ``use_flash``
    runs the attention layers through the flash-attention kernel and the
    Mamba layers' SSD through ``ssd_scan``; without it, both take their
    plain versions (the reference's attention path, ``ssd_scan_plain``)."""
    x = params["embed"][tokens]
    for i in range(n_periods(cfg)):
        x = _period_fwd(cfg, _layer(params["periods"], i), x, use_flash)
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ _head(cfg, params), torch.zeros((), device=x.device)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, use_flash: bool = False):
    """batch: 'tokens' (B, T), 'labels' (B, T) (negative labels are
    masked); optional per-sequence 'ce_weight'."""
    logits, aux = forward(cfg, params, batch["tokens"], use_flash=use_flash)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    ce = softmax_cross_entropy(logits, torch.clamp(labels, min=0))
    if "ce_weight" in batch:
        seq_loss = torch.sum(ce * mask, dim=-1) / torch.clamp(torch.sum(mask, -1), min=1.0)
        loss = torch.sum(batch["ce_weight"].float() * seq_loss)
    else:
        loss = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    """Per period: one attention KV cache and the states of its Mamba
    layers, stacked over periods."""
    _, _, mamba_pos = _pattern(cfg)
    NP = n_periods(cfg)
    kv = attn_mod.init_kv_cache(cfg, batch, max_len, layers_shape=(NP,), device=device)
    ms = mamba_mod.init_mamba_state(cfg, batch, device=device)
    mamba = tree.map(lambda x: x.expand(NP, len(mamba_pos), *x.shape).clone(), ms)
    return {"kv": kv, "mamba": mamba}


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token: torch.Tensor, pos):
    """token (B, 1) at position ``pos`` -> (logits (B, V), cache), the
    cache's KV slots and Mamba states written in place."""
    period, attn_pos, mamba_pos = _pattern(cfg)
    x = params["embed"][token]
    for i in range(n_periods(cfg)):
        pp, kv = _layer(params["periods"], i), _layer(cache["kv"], i)  # views of the cache
        for j in range(period):
            xn = apply_norm(cfg, pp["norms1"][f"l{j}"], x)
            if j in attn_pos:
                h, _ = attn_mod.decode_attention(cfg, pp["mixers"][f"l{j}"], xn, kv, pos)
            else:
                slot = _layer(_layer(cache["mamba"], i), mamba_pos.index(j))
                h, st = mamba_mod.mamba_step(cfg, pp["mixers"][f"l{j}"], xn, slot)
                for key in ("ssm", "conv"):
                    slot[key].copy_(st[key])
            x = x + h
            xn = apply_norm(cfg, pp["norms2"][f"l{j}"], x)
            x = x + mlp_mod.apply_mlp(cfg, pp["ffns"][f"l{j}"], xn)
    x = apply_norm(cfg, params["final_norm"], x)
    return (x @ _head(cfg, params))[:, 0], cache

"""Encoder-decoder backbone (seamless-m4t-style, speech-to-text direction).

The counterpart of ``repro.models.encdec``.  The modality frontend is a
stub, as in the reference: the encoder takes precomputed frame embeddings
of shape (B, frames, d_model).  A bidirectional encoder and a causal
decoder with cross-attention; the layer stacks carry the reference's
leading layer axis and the models loop over it in Python.  The
reference's ``constrain_act`` sharding hints are no-ops on one device and
are left out.

:func:`decode_step` writes the self-attention cache in place (see
:func:`repro_torch.models.attention.decode_attention`) and recomputes the
cross-attention K/V from ``memory`` every step, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    ModelConfig,
    Params,
    apply_norm,
    dense_init,
    embed_init,
    embed_tokens,
    init_norm,
    layer_at,
    masked_lm_loss,
    stack_layers,
    unstack_layers,
)

__all__ = ["init_encdec", "encode", "decode_train", "loss_fn", "init_cache", "decode_step"]


def _init_enc_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "attn": attn_mod.init_attention(cfg, gen),
        "ln2": init_norm(cfg, cfg.d_model, gen.device),
        "ffn": mlp_mod.init_mlp(cfg, gen),
    }


def _init_dec_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "self": attn_mod.init_attention(cfg, gen),
        "ln_x": init_norm(cfg, cfg.d_model, gen.device),
        "cross": attn_mod.init_attention(cfg, gen, cross=True),
        "ln2": init_norm(cfg, cfg.d_model, gen.device),
        "ffn": mlp_mod.init_mlp(cfg, gen),
    }


def init_encdec(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Params on ``gen``'s device, drawn from ``gen``."""
    d = cfg.d_model
    return {
        "frontend_proj": dense_init(gen, (d, d), cfg.tdtype),
        "embed": embed_init(gen, (cfg.vocab_size, d), cfg.tdtype),
        "encoder": stack_layers([_init_enc_block(cfg, gen) for _ in range(cfg.n_encoder_layers)]),
        "enc_norm": init_norm(cfg, d, gen.device),
        "decoder": stack_layers([_init_dec_block(cfg, gen) for _ in range(cfg.n_layers)]),
        "final_norm": init_norm(cfg, d, gen.device),
        "lm_head": dense_init(gen, (d, cfg.vocab_size), cfg.tdtype),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           use_flash: bool = False) -> torch.Tensor:
    """frames (B, F, d) stub frontend embeddings -> encoder memory (B, F, d).
    The encoder's attention is bidirectional: ``use_flash`` does not
    apply to it (kept for the reference's signature)."""
    del use_flash
    x = frames.to(cfg.tdtype) @ params["frontend_proj"]
    for lp in unstack_layers(params["encoder"]):
        # (the reference's constrain_act sharding hint: a no-op on one device)
        x = x + attn_mod.attention(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x),
                                   causal=False, use_flash=False)
        x = x + mlp_mod.apply_mlp(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x))
    return apply_norm(cfg, params["enc_norm"], x)


def decode_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                 *, use_flash: bool = False) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, T) and memory (B, F, d) ->
    logits (B, T, V); the causal self-attention takes the flash kernel
    under ``use_flash``."""
    x = embed_tokens(params, tokens)
    for lp in unstack_layers(params["decoder"]):
        # (the reference's constrain_act sharding hint: a no-op on one device)
        x = x + attn_mod.attention(cfg, lp["self"], apply_norm(cfg, lp["ln1"], x),
                                   use_flash=use_flash)
        x = x + attn_mod.attention(cfg, lp["cross"], apply_norm(cfg, lp["ln_x"], x),
                                   kv_source=memory, causal=False)
        x = x + mlp_mod.apply_mlp(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ params["lm_head"]


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, use_flash: bool = False):
    """batch: 'prefix' (B, F, d) frames, 'tokens' (B, T), 'labels' (B, T)
    (negative labels are masked); optional per-sequence 'ce_weight'."""
    memory = encode(cfg, params, batch["prefix"], use_flash=use_flash)
    logits = decode_train(cfg, params, batch["tokens"], memory, use_flash=use_flash)
    loss = masked_lm_loss(logits, batch)
    return loss, {"ce": loss, "moe_aux": torch.zeros((), device=loss.device)}


# ---------------------------------------------------------------------------
# Decode serving: cached self-attention, cross K/V from memory each step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, memory_len: int,
               device=None) -> Params:
    kv = attn_mod.init_kv_cache(cfg, batch, max_len, layers_shape=(cfg.n_layers,), device=device)
    mem = torch.zeros((batch, memory_len, cfg.d_model), dtype=cfg.tdtype, device=device)
    return {"kv": kv, "memory": mem}


def decode_step(cfg: ModelConfig, params: Params, cache: Params, token: torch.Tensor, pos):
    """token (B, 1) at position ``pos`` -> (logits (B, V), cache), the
    cache's layer slices written in place."""
    x = embed_tokens(params, token)
    memory = cache["memory"]
    B = token.shape[0]
    qpos = torch.full((B, 1), int(pos), device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_at(params["decoder"], i)
        c = layer_at(cache["kv"], i)  # views: the writes land in the stacked cache
        h, _ = attn_mod.decode_attention(cfg, lp["self"], apply_norm(cfg, lp["ln1"], x), c, pos)
        x = x + h
        x = x + attn_mod.attention(cfg, lp["cross"], apply_norm(cfg, lp["ln_x"], x),
                                   kv_source=memory, causal=False, positions=qpos)
        x = x + mlp_mod.apply_mlp(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = (x @ params["lm_head"])[:, 0]
    return logits, cache

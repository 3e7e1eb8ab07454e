"""Grouped-query attention with RoPE, qk-norm, sliding windows, KV caches.

The counterpart of ``repro.models.attention``: one implementation serves
every attention-bearing arch of the zoo (GQA, qk_norm, sliding windows,
logit soft-capping, self- or cross-attention, one-token decode against a
preallocated KV cache).  The plain path below is the reference's jnp
path; ``use_flash=True`` sends causal self-attention without a window to
the hand-written flash-attention kernel through
:func:`repro_torch.kernels.ops.flash_attention`.

The one departure from the reference: :func:`decode_attention` writes the
new key and value into the cache it is given, in place, and returns that
same cache (the reference returns an updated copy).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ModelConfig, Params, apply_rope, dense_init, rms_head_norm

__all__ = [
    "NEG_INF",
    "init_attention",
    "causal_mask",
    "banded_causal_sdpa",
    "attention",
    "init_kv_cache",
    "decode_attention",
]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator, *, cross: bool = False) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (d, H, hd), cfg.tdtype),
        "wk": dense_init(gen, (d, KV, hd), cfg.tdtype),
        "wv": dense_init(gen, (d, KV, hd), cfg.tdtype),
        "wo": dense_init(gen, (H, hd, d), cfg.tdtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=cfg.tdtype, device=gen.device)
        p["k_norm"] = torch.ones(hd, dtype=cfg.tdtype, device=gen.device)
    del cross  # same parameter structure; the kv source differs at apply time
    return p


# ---------------------------------------------------------------------------
# Masking helpers
# ---------------------------------------------------------------------------


def causal_mask(tq: int, tk: int, *, offset: int = 0, window=None, device=None) -> torch.Tensor:
    """(tq, tk) boolean mask; query i attends key j iff j <= i + offset
    (and i + offset - j < window when sliding)."""
    qi = torch.arange(tq, device=device)[:, None] + offset
    kj = torch.arange(tk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= (qi - kj) < window
    return m


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask, softcap: Optional[float]) -> torch.Tensor:
    """q (B,T,H,hd), k/v (B,S,KV,hd) -> (B,T,H,hd).  f32 softmax, masked
    logits at -1e30, output in q's dtype."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / math.sqrt(hd)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def _chunked_causal_sdpa(q, k, v, window, softcap: Optional[float], chunk: int) -> torch.Tensor:
    """Query-blocked causal attention: memory O(chunk x S) per block.  A
    Python loop over the blocks; serving keeps no activations, so the
    reference's per-block checkpointing has nothing to do here."""
    T, S = q.shape[1], k.shape[1]
    kj = torch.arange(S, device=q.device)[None, :]
    outs = []
    for off in range(0, T, chunk):
        qidx = off + torch.arange(chunk, device=q.device)[:, None]
        m = kj <= qidx
        if window is not None:
            m &= (qidx - kj) < window
        outs.append(_sdpa(q[:, off:off + chunk], k, v, m, softcap))
    return torch.cat(outs, dim=1)


def banded_causal_sdpa(q, k, v, window: int, softcap: Optional[float], chunk: int) -> torch.Tensor:
    """Statically banded sliding-window attention: each query block reads
    only the (window + chunk) keys it can see."""
    T = q.shape[1]
    band = window + chunk
    outs = []
    for o in range(0, T, chunk):
        start = max(0, o + chunk - band)
        width = min(band, o + chunk)
        qidx = o + torch.arange(chunk, device=q.device)[:, None]
        kidx = start + torch.arange(width, device=q.device)[None, :]
        m = (kidx <= qidx) & ((qidx - kidx) < window)
        outs.append(_sdpa(q[:, o:o + chunk], k[:, start:start + width],
                          v[:, start:start + width], m, softcap))
    return torch.cat(outs, dim=1)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device).expand(B, T)


def attention(
    cfg: ModelConfig,
    params: Params,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_source: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    window=None,
    static_window: Optional[int] = None,
    causal: bool = True,
    use_flash: bool = False,
) -> torch.Tensor:
    """Full-sequence attention; ``kv_source`` switches to cross-attention
    (no causal mask).  The branches are the reference's, in its order."""
    B, T, _ = x.shape
    if positions is None:
        positions = _positions(B, T, x.device)
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    src = x if kv_source is None else kv_source
    S = src.shape[1]
    if kv_positions is None:
        kv_positions = _positions(B, S, x.device)
    k = torch.einsum("bsd,dhk->bshk", src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, params["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, kv_positions, cfg.rope_theta)

    is_self_causal = kv_source is None and causal
    if is_self_causal and static_window is not None and T > cfg.attn_chunk:
        out = banded_causal_sdpa(q, k, v, static_window, cfg.attn_logit_softcap, cfg.attn_chunk)
    elif use_flash and is_self_causal and window is None:
        out = kops.flash_attention(q, k, v, causal=True)
    elif is_self_causal and T > cfg.attn_chunk and T % cfg.attn_chunk == 0:
        out = _chunked_causal_sdpa(q, k, v, window, cfg.attn_logit_softcap, cfg.attn_chunk)
    else:
        mask = causal_mask(T, S, window=window, device=x.device) if is_self_causal else None
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    return torch.einsum("bthk,hkd->btd", out, params["wo"])


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers_shape=(),
                  device=None) -> Params:
    shape = (*layers_shape, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def decode_attention(cfg: ModelConfig, params: Params, x: torch.Tensor, cache: Params, pos: int,
                     *, window=None) -> tuple[torch.Tensor, Params]:
    """One-token decode.  x (B, 1, d); cache k/v (B, S, KV, hd); ``pos``
    the index being written (0 <= pos < S).  Writes the new key and value
    at ``pos`` in place and returns ``(output (B, 1, d), cache)``."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    pos = int(pos)
    if not 0 <= pos < S:
        raise IndexError(f"decode position {pos} outside the cache's {S} slots")
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k_new = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v_new = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k_new = rms_head_norm(k_new, params["k_norm"])
    posb = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)

    idx = torch.arange(S, device=x.device)
    valid = idx <= pos
    if window is not None:
        valid &= (pos - idx) < window
    out = _sdpa(q, cache["k"], cache["v"], valid[None, :], cfg.attn_logit_softcap)
    y = torch.einsum("bthk,hkd->btd", out, params["wo"])
    return y, cache

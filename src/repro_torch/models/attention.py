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

from repro_torch.dist.layout import (as_layout, attend_sequence_sharded, heads_layout,
                                      is_dtensor, local_of, merge_ready, shard_ways, write_at)
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


def _logits(q, k, softcap: Optional[float]) -> torch.Tensor:
    """q (B,T,H,hd), k (B,S,KV,hd) -> the f32 logits (B,KV,G,T,S), scaled
    and soft-capped."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, T, KV, H // KV, hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / math.sqrt(hd)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def _sdpa(q, k, v, mask, softcap: Optional[float]) -> torch.Tensor:
    """q (B,T,H,hd), k/v (B,S,KV,hd) -> (B,T,H,hd).  f32 softmax, masked
    logits at -1e30, output in q's dtype.  On a mesh (DTensors) k and v
    are laid out on q's heads (:func:`heads_layout`) and the same
    arithmetic runs on each rank's local tensors."""
    if is_dtensor(q):
        q, k, v = heads_layout(q, k, v)
        return as_layout(_sdpa(local_of(q), local_of(k), local_of(v), mask, softcap), q)
    B, T, H, hd = q.shape
    logits = _logits(q, k, softcap)
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
    x = merge_ready(x)
    kv_source = merge_ready(kv_source) if kv_source is not None else None
    wq, wk, wv = (merge_ready(params[n], 2, 1) for n in ("wq", "wk", "wv"))
    if positions is None:
        positions = _positions(B, T, x.device)
    q = torch.einsum("btd,dhk->bthk", x, wq)
    src = x if kv_source is None else kv_source
    S = src.shape[1]
    if kv_positions is None:
        kv_positions = _positions(B, S, x.device)
    k = torch.einsum("bsd,dhk->bshk", src, wk)
    v = torch.einsum("bsd,dhk->bshk", src, wv)
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, kv_positions, cfg.rope_theta)
    if is_dtensor(q):  # on a mesh: k and v on q's heads once, before any query block
        q, k, v = heads_layout(q, k, v)

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
    return torch.einsum("bthk,hkd->btd", merge_ready(out), merge_ready(params["wo"]))


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
    wq, wk, wv = (merge_ready(params[n], 2, 1) for n in ("wq", "wk", "wv"))
    q = torch.einsum("btd,dhk->bthk", x, wq)
    k_new = torch.einsum("btd,dhk->bthk", x, wk)
    v_new = torch.einsum("btd,dhk->bthk", x, wv)
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k_new = rms_head_norm(k_new, params["k_norm"])
    posb = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    write_at(cache["k"], 1, pos, k_new[:, 0].to(cache["k"].dtype))
    write_at(cache["v"], 1, pos, v_new[:, 0].to(cache["v"].dtype))

    def valid(lo: int, n: int) -> torch.Tensor:
        """Which of the cache slots ``lo .. lo + n - 1`` the token attends."""
        idx = lo + torch.arange(n, device=x.device)
        ok = idx <= pos
        if window is not None:
            ok &= (pos - idx) < window
        return ok

    if shard_ways(cache["k"], 1) > 1:
        # a sequence-sharded cache: each rank attends its own slots, the
        # softmax's max and sum reduced over the ranks
        def scores(ql, kl, lo):
            return _logits(ql, kl, cfg.attn_logit_softcap).masked_fill(
                ~valid(lo, kl.shape[1]), NEG_INF)

        out = attend_sequence_sharded(q, cache["k"], cache["v"], scores).to(q.dtype)
    else:
        out = _sdpa(q, cache["k"], cache["v"], valid(0, S)[None, :], cfg.attn_logit_softcap)
    y = torch.einsum("bthk,hkd->btd", merge_ready(out), merge_ready(params["wo"]))
    return y, cache

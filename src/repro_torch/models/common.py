"""Model substrate shared by the port's models: the zoo's config, its
initializers, norms, rotary embeddings and loss.

The counterpart of ``repro.models.common``.  Parameters are plain nested
dicts of tensors under the reference's key paths and layouts; layer
stacks keep the reference's leading layer axis, and the models loop over
it in Python (the reference scans it).  Initializers draw from an
explicit :class:`torch.Generator` and create their tensors on that
generator's device; the draws differ from ``jax.random``'s, so parity
tests feed the port the reference's params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import tree

__all__ = [
    "Params",
    "ModelConfig",
    "dense_init",
    "embed_init",
    "init_norm",
    "apply_norm",
    "rms_head_norm",
    "rope_frequencies",
    "apply_rope",
    "softmax_cross_entropy",
    "count_params",
    "stack_layers",
    "layer_at",
    "unstack_layers",
    "lm_head",
    "embed_tokens",
    "masked_lm_loss",
]

Params = Any  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Union config covering every architecture family of the zoo (the
    reference's fields and defaults, value for value)."""

    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm | audio | cnn
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 256
    max_seq_len: int = 4096
    # --- norms / attention details ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    mlp: str = "swiglu"  # swiglu | gelu | relu_sq
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_ratio: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: Optional[int] = None
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM / hybrid ---
    ssm_d_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64
    ssm_heads: Optional[int] = None
    attn_every: int = 0
    moe_every: int = 0
    # --- enc-dec / multimodal ---
    n_encoder_layers: int = 0
    frontend_tokens: int = 0  # audio frames / vision patches provided by stub
    # --- dtype / memory ---
    dtype: str = "float32"
    remat: bool = True  # the reference's training remat; serving ignores it
    scan_unroll: bool = False
    # self-attention switches to the query-blocked path (memory O(block x S)
    # instead of O(T x S)) when the sequence is longer than this
    attn_chunk: int = 2048
    act_spec: Optional[tuple] = None
    moe_buf_spec: Optional[tuple] = None
    static_window_pattern: bool = False
    # --- FL execution ---
    fl_mode: str = "per_client"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads if self.ssm_heads is not None else max(1, self.d_inner // 64)

    @property
    def ffe(self) -> int:
        return self.d_ff_expert if self.d_ff_expert is not None else self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal at +-2, scaled by ``1/sqrt(fan_in)`` (fan-in is
    ``shape[-2]``, as in the reference), drawn in f32 on ``gen``'s device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    t = torch.randn(tuple(shape), dtype=torch.float32, device=gen.device, generator=gen)
    return (t * 0.02).to(dtype)


def stack_layers(layers: Sequence[Params]) -> Params:
    """Per-layer trees -> one tree whose leaves carry a leading layer axis."""
    return tree.map(lambda *xs: torch.stack(xs), *layers)


def layer_at(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views (writes land in the stack)."""
    return tree.map(lambda x: x[i], stacked)


def unstack_layers(stacked: Params) -> List[Params]:
    """Every layer of a stacked tree, as views: one ``unbind`` a leaf, so a
    backward pass writes each leaf's gradient once, as one stack (indexing
    each layer, ``x[i]``, instead writes a zero gradient the size of the
    whole stack for every layer and adds them up)."""
    leaves, treedef = tree.flatten(stacked)
    per_leaf = [x.unbind(0) for x in leaves]
    return [tree.unflatten(treedef, [u[i] for u in per_leaf]) for i in range(len(per_leaf[0]))]


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``params["embed"]`` for ``tokens``.  ``F.embedding``'s
    backward sums the gradients of repeated tokens in a fixed order on the
    CPU and on CUDA; indexing's (``embed[tokens]``, an accumulating
    ``index_put_``) does not on several CPU threads, which made two runs of
    the same training differ in the last bit."""
    return F.embedding(tokens, params["embed"])


def lm_head(cfg: "ModelConfig", params: Params) -> torch.Tensor:
    """The (d_model, V) output projection: the embedding's transpose when tied."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: int, device=None) -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(dim, dtype=cfg.tdtype, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(dim, dtype=cfg.tdtype, device=device),
                "bias": torch.zeros(dim, dtype=cfg.tdtype, device=device)}
    if cfg.norm == "nonparametric_ln":  # OLMo: LN without affine params
        return {}
    raise ValueError(f"unknown norm {cfg.norm}")


def apply_norm(cfg: ModelConfig, params: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics (mean, population variance), cast to the working
    dtype before the affine, as the reference does."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * inv).to(x.dtype) * params["scale"]
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        return y.to(x.dtype) * params["scale"] + params["bias"]
    if cfg.norm == "nonparametric_ln":
        return y.to(x.dtype)
    raise ValueError(f"unknown norm {cfg.norm}")


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm used for qk_norm (Qwen3-style)."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * scale


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, D); positions broadcastable to (..., T).  Split halves
    (not interleaved), f32 inside, output in x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions[..., :, None, None].float() * freqs  # (..., T, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses / misc
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE; logits (..., V), labels (...) integer.  f32 inside:
    logsumexp minus the gold logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return logz - gold


def masked_lm_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Mean cross-entropy of ``batch['labels']`` (B, T), negative labels
    masked; with ``batch['ce_weight']`` (B,) the per-sequence means weighted
    by it (the flat ColRel round: w_{client(seq)}/B)."""
    labels = batch["labels"]
    mask = (labels >= 0).float()
    ce = softmax_cross_entropy(logits, torch.clamp(labels, min=0))
    if "ce_weight" in batch:
        seq_loss = torch.sum(ce * mask, dim=-1) / torch.clamp(torch.sum(mask, -1), min=1.0)
        return torch.sum(batch["ce_weight"].float() * seq_loss)
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)


def count_params(params: Params) -> int:
    return sum(x.numel() for x in tree.leaves(params))

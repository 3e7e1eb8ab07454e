"""Mixture-of-Experts layer with capacity-based static dispatch.

The counterpart of ``repro.models.moe``, with its semantics: every token's
top-k experts by router probability; each (token, expert) assignment takes
the next free slot of its expert in route-priority order (the flattened
``(N*K,)`` list), and an assignment past the expert's capacity is dropped;
the experts run as fixed-shape ``(E, C, d) x (E, d, f)`` batched matmuls;
the outputs come back weighted by the renormalized gates.  The aux loss is
the Switch/DBRX load balance ``E * sum_e f_e * P_e``.

Two choices make the card's result the reference's and the same from run
to run:

* the top-k breaks ties as XLA's ``top_k`` does, the lower expert index
  first: a stable descending sort of the f32 probabilities
  (``torch.topk`` promises no order among equal scores on CUDA);
* the combine adds each token's K contributions, which are contiguous, as
  a sum over K of an ``(N, K, d)`` view, not with atomics.

On a mesh the reference's sharding constraints pin the flattened
``(N, ...)`` token tensors to ``act_spec``'s batch (or sequence) axis and
the ``(E, C, d)`` dispatch buffers to ``moe_buf_spec``
(:func:`repro_torch.dist.constrain`, the identity outside a mesh).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.constraints import constrain
from repro_torch.dist.layout import merge_ready, split_ready
from repro_torch.models.common import ModelConfig, Params, dense_init

__all__ = ["init_moe", "capacity", "Routing", "route", "apply_moe"]


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.ffe
    return {
        "router": dense_init(gen, (d, E), cfg.tdtype),
        "wg": dense_init(gen, (E, d, f), cfg.tdtype),
        "wu": dense_init(gen, (E, d, f), cfg.tdtype),
        "wd": dense_init(gen, (E, f, d), cfg.tdtype),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert has for ``n_tokens`` tokens: at least 128, a
    multiple of 128."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(128, -(-c // 128) * 128)


class Routing(NamedTuple):
    """Where the assignments of ``N`` tokens go, in route-priority order."""

    probs: torch.Tensor  # (N, E) f32 router probabilities
    expert: torch.Tensor  # (N, K) chosen experts, the most probable first
    gate: torch.Tensor  # (N, K) f32 gates, renormalized over the K
    slot: torch.Tensor  # (N*K,) row of the (E*C, d) buffer; E*C when dropped
    keep: torch.Tensor  # (N*K,) bool, False where the expert was full
    capacity: int


def route(cfg: ModelConfig, params: Params, xt: torch.Tensor) -> Routing:
    """Routing of the tokens ``xt`` (N, d)."""
    N = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(N, cfg)
    probs = torch.softmax((xt @ params["router"]).float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)  # ties: lower index first
    gate, expert = top.values[:, :K], top.indices[:, :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # each assignment's position within its expert: the count of earlier
    # assignments to the same expert over the flattened (N*K,) list.  The
    # one-hot is laid out (E, N*K), so that the running count is a scan
    # along contiguous rows (over (N*K, E) it is a sequential walk down E
    # columns: 5.7 ms a layer for granite-moe's 32768 x 40 on an H100)
    flat = expert.reshape(-1)
    onehot = (torch.arange(E, device=xt.device)[:, None] == flat[None, :]).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot).gather(0, flat[None, :])[0]
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, E * C)
    return Routing(probs, expert, gate, slot, keep, C)


def apply_moe(cfg: ModelConfig, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y (B, T, d), f32 aux loss)."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * T

    def tok(t):
        # keep the flattened (N, ...) token tensors sharded after the (B, T)
        # merge, which otherwise drops act_spec's batch sharding
        ax = cfg.act_spec and (cfg.act_spec[0] or cfg.act_spec[1])
        return constrain(t, (ax,) + (None,) * (t.ndim - 1)) if ax else t

    def buf_spec(b):
        return constrain(b, cfg.moe_buf_spec) if cfg.moe_buf_spec else b

    xt = tok(merge_ready(x).reshape(N, d))
    r = route(cfg, params, xt)
    C = r.capacity

    # dispatch: the kept slots are distinct; the dropped ones all land in
    # the extra row E*C, which is cut off
    buf = xt.new_zeros(E * C + 1, d)
    buf[r.slot] = xt.repeat_interleave(K, dim=0)
    buf = buf_spec(buf[:E * C].view(E, C, d))

    # the experts: static shapes
    h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wu"])
    out = merge_ready(buf_spec(torch.bmm(h, params["wd"]))).view(E * C, d)

    # combine: token i's K contributions are rows i*K .. i*K + K - 1
    contrib = tok(out[torch.clamp(r.slot, max=E * C - 1)])
    contrib = torch.where(r.keep[:, None], contrib, 0.0)
    contrib = contrib * r.gate.reshape(-1)[:, None].to(x.dtype)
    y = tok(contrib.view(N, K, d).sum(1))

    # load-balance aux: f_e the fraction of the assignments, P_e the mean probability
    frac = F.one_hot(r.expert, E).float().sum(1).mean(0) / K
    aux = E * torch.sum(frac * r.probs.mean(0))
    return split_ready(y, 0, B).reshape(B, T, d), aux.float()

"""Roofline terms on one NVIDIA H100, the port's counterpart of
``repro.launch.roofline``.

The constants are NVIDIA's published figures for the H100 SXM 80GB (dense
rates, no sparsity), which assume the card's full 700 W power limit; the
card the port is measured on reports "NVIDIA H100 80GB HBM3, 700 W".  A
card set below 700 W runs slower under load, so a time read against these
terms names the card's power limit beside it.

    compute    = FLOPs / BF16_FLOPS          (989 TFLOP/s, bf16 tensor cores)
    memory     = bytes / HBM_BYTES_PER_S     (3.35 TB/s)
    collective = 0                           (one card has no collectives)

The reference's ``collective_bytes`` parses XLA's partitioned HLO; one
card runs no collective, so it has no counterpart here.

MODEL_FLOPS uses the 6·N·D (train) / 2·N·D (inference) convention with
N = active parameters (a MoE discounts its unrouted experts).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

from repro_torch import tree

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOPS", "F32_FLOPS", "roofline_terms", "count_params_split",
           "model_flops"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores

# the reference's expert-leaf rule: a routed expert's stacked weight
_EXPERT_LEAF = re.compile(r"ffns?.*/(wg|wu|wd)$")


def roofline_terms(flops: float, bytes_: float) -> Dict[str, Any]:
    """Seconds a step takes at the card's peak compute and at its peak
    memory rate, and which of the two bounds it."""
    terms = {"compute_s": flops / BF16_FLOPS, "memory_s": bytes_ / HBM_BYTES_PER_S,
             "collective_s": 0.0}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return terms


def count_params_split(params: Any, n_experts: int, top_k: int) -> Dict[str, float]:
    """Total and active parameter counts of a tree of tensors (meta or fake
    tensors will do: only shapes are read)."""
    total = expert = 0
    for path, leaf in zip(tree.paths(params), tree.leaves(params)):
        n = math.prod(leaf.shape)
        total += n
        if n_experts > 0 and _EXPERT_LEAF.search(path.replace(".", "/")) and leaf.ndim >= 3:
            expert += n
    active = total
    if n_experts > 0 and expert:
        active = total - expert * (1.0 - top_k / n_experts)
    return {"total": float(total), "active": float(active)}


def model_flops(kind: str, n_active: float, tokens: float) -> float:
    """6ND for training (forward and backward), 2ND for an inference forward."""
    return (6.0 if kind == "train" else 2.0) * n_active * tokens

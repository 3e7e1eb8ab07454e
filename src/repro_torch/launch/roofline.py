"""Roofline terms on an NVIDIA H100, the port's counterpart of
``repro.launch.roofline``.

The constants are NVIDIA's published figures for the H100 SXM 80GB (dense
rates, no sparsity), which assume the card's full 700 W power limit; the
card the port is measured on reports "NVIDIA H100 80GB HBM3, 700 W".  A
card set below 700 W runs slower under load, so a time read against these
terms names the card's power limit beside it.

    compute    = FLOPs / BF16_FLOPS            (989 TFLOP/s, bf16 tensor cores)
    memory     = bytes / HBM_BYTES_PER_S       (3.35 TB/s)
    collective = bytes / LINK_BYTES_PER_S      (50 GB/s)

The collective term prices one device's collective output bytes at one
400 Gb/s NDR InfiniBand port per GPU, 50 GB/s: the network of NVIDIA's
DGX H100 (8 GPUs a node, one port each).  Every axis of the 16 x 16 and
2 x 16 x 16 meshes spans more than one 8-GPU node, so every collective of
the dry run crosses that network; NVLink inside a node is faster and is
not what bounds them.

The reference's ``collective_bytes`` parses XLA's partitioned HLO and sums
the output bytes of each communication op.  Here the same sum is counted
as the ops run (:class:`repro_torch.launch.dryrun.StepCounter`): the
output bytes of each functional collective (``_c10d_functional``) one
rank issues, under the reference's five names (:func:`collective_name`).

MODEL_FLOPS uses the 6·N·D (train) / 2·N·D (inference) convention with
N = active parameters (a MoE discounts its unrouted experts).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

from repro_torch import tree

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOPS", "F32_FLOPS", "LINK_BYTES_PER_S", "COLLECTIVES",
           "collective_name", "roofline_terms", "count_params_split", "model_flops"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
LINK_BYTES_PER_S = 50e9    # one 400 Gb/s NDR InfiniBand port per GPU (DGX H100)

#: the reference's collective op names
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# functional collective op name -> the reference's name
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}

# the reference's expert-leaf rule: a routed expert's stacked weight
_EXPERT_LEAF = re.compile(r"ffns?.*/(wg|wu|wd)$")


def collective_name(func) -> Optional[str]:
    """The reference's name of a functional collective op (an
    ``OpOverload`` of ``_c10d_functional``), else None."""
    if not func.namespace.endswith("c10d_functional"):
        return None
    return _FUNCTIONAL.get(func._overloadpacket.__name__)


def roofline_terms(flops: float, bytes_: float, coll_bytes: float = 0.0) -> Dict[str, Any]:
    """Seconds a step takes at the card's peak compute, at its peak memory
    rate and at its network port's rate, and which of the three bounds it."""
    terms = {"compute_s": flops / BF16_FLOPS, "memory_s": bytes_ / HBM_BYTES_PER_S,
             "collective_s": coll_bytes / LINK_BYTES_PER_S}
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

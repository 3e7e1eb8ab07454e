"""The comparison that decides ``correct``: what the window's own call
produced in the first chunk, against the plain reference's rounds from the
same inputs.

Four numbers, each against the limit of its own in the cell's workload
file:

* ``loss_gap``: the widest relative gap of a round's mean client loss;
* ``delta_norm_gap``: the widest relative gap of the norm of a round's PS
  delta, the pseudo-gradient as the server's optimizer gets it;
* ``momentum_gap``: the worst leaf's gap between the norms of the PS
  momentum after the chunk, against the reference's norm of that leaf or
  of the median leaf, whichever is larger;
* ``change_gap``: the same of the parameters' change over the chunk.

A leaf whose reference momentum is under a thousandth of the median
leaf's moves by round-off alone and is left out of the last two.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["NUMBERS", "leaf_norms", "readout", "compare"]

NUMBERS = ("loss_gap", "delta_norm_gap", "momentum_gap", "change_gap")
_KEEP_BELOW_MEDIAN = 1e-3


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in leaves.items()}


def readout(loss: Sequence[float], delta_norm: Sequence[float], momentum: Dict[str, float],
            change: Dict[str, float]) -> Dict[str, object]:
    return {"loss": [float(x) for x in loss], "delta_norm": [float(x) for x in delta_norm],
            "momentum": dict(momentum), "change": dict(change)}


def _rel(a: float, b: float, base: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / base if base > 0 else (0.0 if a == b else math.inf)


def _series_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return math.inf
    return max(_rel(a, b, abs(b)) for a, b in zip(prog, ref))


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    if set(prog) != set(ref) or not keep:
        return math.inf
    median = statistics.median(ref[k] for k in keep)
    return max(_rel(prog[k], ref[k], max(ref[k], median)) for k in keep)


def compare(prog: Dict[str, object], ref: Dict[str, object],
            limits: Dict[str, float]) -> Tuple[Dict[str, Dict[str, float]], bool, List[str]]:
    """``(numbers, correct, left_out)``: each number with its limit, whether
    every number is within its limit, and the leaves left out."""
    median = statistics.median(ref["momentum"].values())
    keep = sorted(k for k, v in ref["momentum"].items() if v >= _KEEP_BELOW_MEDIAN * median)
    left_out = sorted(set(ref["momentum"]) - set(keep))
    values = {
        "loss_gap": _series_gap(prog["loss"], ref["loss"]),
        "delta_norm_gap": _series_gap(prog["delta_norm"], ref["delta_norm"]),
        "momentum_gap": _leaf_gap(prog["momentum"], ref["momentum"], keep),
        "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
    }
    numbers = {k: {"value": values[k], "limit": float(limits[k])} for k in NUMBERS}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    return numbers, correct, left_out

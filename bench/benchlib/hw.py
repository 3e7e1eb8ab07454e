"""Published peaks of the chips the benchmark runs on, and what a run
reports of the device.

NVIDIA's data sheet for the H100 SXM 80GB, dense rates without sparsity,
at the card's full 700 W power limit: 989 TFLOP/s bf16 and fp16 on the
tensor cores, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside the tensor cores,
3.35 TB/s of device memory.  A configuration names the rate its ``mfu`` is
a share of (``peak``); a kernel's roofline takes the memory and f32 rates.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

PEAK_FLOPS: Dict[str, float] = {
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "f32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(name: str) -> float:
    if name not in PEAK_FLOPS:
        raise KeyError(f"unknown peak {name!r}; have {sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[name]


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None
    where it cannot be asked."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None

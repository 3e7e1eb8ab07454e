"""The ColRel relay consensus ``Dx~ = M @ Dx`` (paper Eq. (3)) as a
hand-written Hopper kernel, and its plain PyTorch version.

Replaces ``repro/kernels/relay_mix.py``: :func:`relay_mix_cuda` for
``relay_mix_pallas``, the (n, d) consensus for a given (n, n) realized
mask ``M = A * tau_dd^T``, in the stack's dtype with f32 accumulation.
It is the C = 1 case of the blocked relay mix and runs the same CUDA
kernel (``csrc/relay_block.cu``) with the mask copied, not computed: the
mask sits in shared memory, which bounds n at 110.  The plain version is
the blocked one's arithmetic with one cluster, so the two agree to the
bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_aggregate import _operand, _raise_on
from repro_torch.kernels.relay_block import DTYPE_CODES, MAX_MIX_M, check_stack, mix_plain

__all__ = ["relay_mix_plain", "relay_mix_cuda"]


def relay_mix_plain(mixing: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`relay_mix_cuda`: (n, d) in the stack's dtype."""
    return mix_plain(mixing.float()[None], updates)


def relay_mix_cuda(mixing: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``mixing @ updates`` for an (n, n) mask and an (n, d) f32 or bf16
    CUDA stack, n <= 110; returns (n, d) in the stack's dtype."""
    n = updates.shape[0] if updates.ndim == 2 else -1
    if not 1 <= n <= MAX_MIX_M:
        raise ValueError(f"relay_mix: the (n, n) mask lives in shared memory, "
                         f"needs an (n, d) stack with 1 <= n <= {MAX_MIX_M}, "
                         f"got {tuple(updates.shape)}")
    check_stack(updates, n, "relay_mix")
    d, dev = updates.shape[1], updates.device
    mix = _operand(mixing, (n, n), dev, "mixing")
    out = torch.empty_like(updates)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_relay_mix(mix.data_ptr(), updates.data_ptr(), out.data_ptr(), n, d,
                                  DTYPE_CODES[updates.dtype],
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "relay_mix")
    relay_mix_cuda.launches += 1
    return out


relay_mix_cuda.launches = 0

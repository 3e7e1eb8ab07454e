"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the device dispatch in :mod:`repro_torch.kernels.ops`.

* ``fused_aggregate`` — the full ColRel aggregation (mixing mask + relay
  mix + tau-weighted blind PS sum) in one pass over the (n, d) stack.
* ``row_stream`` — its segment-streaming twin, ``w @ segment``.
* ``fused_memory`` — the memory strategy's select-accumulate-update.
* ``fused_dequant`` — the aggregation over the int8 wire stack.
* ``relay_block`` — the clustered (block-sparse) relay mix, aggregation
  and segment stream over ``(C, m, m)`` blocks; ``relay_mix`` — the
  dense relay mix for a given mask, the same kernel with one cluster.
* ``flash_attention`` — the model zoo's causal self-attention (online
  softmax, dead kv tiles skipped) over strided ``(B, T, H, D)`` views with
  grouped kv heads read in place; in bf16, P V on the tensor cores.
* ``ssd_scan`` — Mamba2's chunked SSD recurrence from a zero state, the
  state carried chunk to chunk inside one block.

Sources are in ``csrc/`` and are compiled by :mod:`.build` at first use.
Each ``*_cuda`` wrapper counts its launches in ``launches``;
:func:`launch_counts` reads them all.  The entry points are in
:mod:`.ops`, which dispatches on the tensor's device; the wrappers of the
reference's four exported ``*_pallas`` kernels are exported here too.
"""

from . import ops
from .flash_attention import flash_attention_cuda
from .fused_aggregate import fused_aggregate_cuda
from .relay_mix import relay_mix_cuda
from .ssd_scan import ssd_scan_cuda

__all__ = [
    "ops",
    "launch_counts",
    "flash_attention_cuda",
    "fused_aggregate_cuda",
    "relay_mix_cuda",
    "ssd_scan_cuda",
]


def launch_counts() -> dict:
    """``{wrapper name: launches}`` of every kernel wrapper, read, not reset."""
    from repro_torch.kernels import (flash_attention, fused_aggregate, fused_dequant,
                                     fused_memory, relay_block, relay_mix, ssd_scan)

    return {name: fn.launches
            for mod in (fused_aggregate, fused_dequant, fused_memory, relay_block, relay_mix,
                        flash_attention, ssd_scan)
            for name, fn in vars(mod).items()
            if name.endswith("_cuda") and hasattr(fn, "launches")}

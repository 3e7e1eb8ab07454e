"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the device dispatch in :mod:`repro_torch.kernels.ops`.

* ``fused_aggregate`` — the full ColRel aggregation (mixing mask + relay
  mix + tau-weighted blind PS sum) in one pass over the (n, d) stack.
* ``row_stream`` — its segment-streaming twin, ``w @ segment``.

Sources are in ``csrc/`` and are compiled by :mod:`.build` at first use.
"""

"""repro_torch: ColRel (collaborative-relaying federated learning) in PyTorch.

The PyTorch/CUDA port of the ``repro`` package.  Module names mirror the
reference so that each counterpart is easy to find: core (connectivity,
topologies, COPT-alpha, flatten, relay algebra), kernels (hand-written
Hopper kernels with their plain PyTorch versions), optim, models,
configs, data, channel, strategies and fl (round, trainer, experiment).

The port imports ``torch`` and ``numpy`` only.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

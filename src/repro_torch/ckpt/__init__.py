"""Fault-tolerant checkpoint/resume, the port of ``repro.ckpt``.

* :mod:`repro_torch.ckpt.schema` — the versioned run-state tree:
  :func:`capture_run_state` / :func:`restore_run_state` cover params,
  optimizer state, the strategy's carried state, the channel's generator
  state, the clients' data streams, the ``no_trace`` sampler's carry, the
  estimator, the telemetry streak and logger, and the round counter.
* :mod:`repro_torch.ckpt.writer` — sha256-checksummed atomic commits with
  keep-last-k retention; :class:`AsyncCheckpointer` snapshots on the
  device and writes in a background thread.
* :mod:`repro_torch.ckpt.keys` — ``torch.Generator`` (de)serialization.
* :mod:`repro_torch.ckpt.preemption` — :class:`PreemptionGuard`, latching
  SIGTERM/SIGINT so a loop drains and commits before it exits.

Entry points: ``FLTrainer.run(ckpt_dir=..., ckpt_every=...,
resume_from=...)``, ``FLTrainer.save_checkpoint`` / ``restore``, and the
``ckpt_*`` / ``resume_from`` fields of ``ExperimentSpec``.
"""

from repro_torch.ckpt.keys import decode_generator, encode_generator, is_encoded_generator
from repro_torch.ckpt.preemption import PreemptionGuard
from repro_torch.ckpt.schema import (
    CKPT_VERSION,
    capture_run_state,
    restore_run_state,
    rng_from_json,
    rng_state_to_json,
)
from repro_torch.ckpt.writer import (
    AsyncCheckpointer,
    CheckpointWriter,
    read_state,
    snapshot,
    write_state,
)

__all__ = [
    "CKPT_VERSION",
    "AsyncCheckpointer",
    "CheckpointWriter",
    "PreemptionGuard",
    "capture_run_state",
    "decode_generator",
    "encode_generator",
    "is_encoded_generator",
    "read_state",
    "restore_run_state",
    "rng_from_json",
    "rng_state_to_json",
    "snapshot",
    "write_state",
]

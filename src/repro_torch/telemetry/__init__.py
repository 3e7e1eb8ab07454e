"""Observability: three tiers, the port of ``repro.telemetry``.

1. **Device tier** (:mod:`repro_torch.telemetry.device`) — per-client
   vector metrics computed inside the round (participation, bits on air,
   the int32 outage-streak carry) and the unbiasedness drift, stacked
   ``(K, n)`` a chunk by the chunked engine.
2. **Host tier** (:mod:`repro_torch.telemetry.logger`,
   :mod:`repro_torch.telemetry.manifest`) — one append path for every
   metric stream, pluggable sinks (JSONL events, CSV summary, in memory),
   health events (``health.nan``, ``health.recompile``), and a
   :class:`RunManifest` written at run start.
3. **Timing tier** (:mod:`repro_torch.telemetry.timing`) — fenced
   throughput, the chunked engine's capture count, and opt-in
   ``torch.profiler`` windows.
"""

from repro_torch.telemetry.device import (
    VECTOR_DTYPES,
    VECTOR_METRICS,
    init_streak,
    instrument_round_fn,
    update_streak,
)
from repro_torch.telemetry.logger import (
    SCALAR_STREAMS,
    CsvSummarySink,
    JsonlSink,
    MemorySink,
    MetricsLogger,
    MetricsSink,
    TrainLog,
)
from repro_torch.telemetry.manifest import RunManifest, config_digest, git_sha
from repro_torch.telemetry.timing import CompileTracker, ProfileWindow, ThroughputMeter

__all__ = [
    "VECTOR_METRICS",
    "VECTOR_DTYPES",
    "SCALAR_STREAMS",
    "init_streak",
    "update_streak",
    "instrument_round_fn",
    "MetricsSink",
    "JsonlSink",
    "CsvSummarySink",
    "MemorySink",
    "MetricsLogger",
    "TrainLog",
    "RunManifest",
    "config_digest",
    "git_sha",
    "CompileTracker",
    "ProfileWindow",
    "ThroughputMeter",
]

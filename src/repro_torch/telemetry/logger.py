"""Host-side metrics pipeline: one append path, pluggable sinks.

The port of ``repro.telemetry.logger``.  :class:`MetricsLogger` is the one
place every metric stream passes through: the per-round loop and the
chunked engine both call :meth:`MetricsLogger.log_rounds`, whose one
device-to-host copy and float64 widening feed the :class:`TrainLog` facade
(``trainer.log is trainer.metrics.log``), the ``round_metrics`` table of
every scalar a round returns, the vector histories and the sinks.

Sinks:

* :class:`JsonlSink` — append-only ``events.jsonl``, one compact JSON
  object a line, buffered;
* :class:`CsvSummarySink` — the per-round scalar table ``rounds.csv``;
* :class:`MemorySink` — an in-process list.

Event kinds and fields are the reference's: ``round`` (per-round
scalars), ``eval``, ``reopt``, ``timing`` (per-chunk wall clock and
rounds/s), ``health.nan`` (a non-finite loss), ``health.recompile`` (a
capture of the chunked engine past the first of its round) and
``summary.clients`` (end-of-run per-client aggregates of the vector
metrics).  Every event carries ``seq``, its place in emission order.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.telemetry.device import VECTOR_METRICS

__all__ = ["TrainLog", "MetricsSink", "JsonlSink", "CsvSummarySink", "MemorySink",
           "MetricsLogger", "SCALAR_STREAMS"]

#: scalar streams a round event carries, mapped to their TrainLog field
#: (None: event only)
SCALAR_STREAMS = {
    "loss": "loss",
    "participation": "participation",
    "uplink_bits": "uplink_bits",
    "weight_sum": "weight_sums",
    "weight_drift": None,
    "delta_norm": None,
    "mean_age": None,
    "max_age": None,
    "stale_frac": None,
}


@dataclasses.dataclass
class TrainLog:
    """Per-round metric streams, under the reference's field names."""

    rounds: List[int] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    eval_rounds: List[int] = dataclasses.field(default_factory=list)
    eval_metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    participation: List[float] = dataclasses.field(default_factory=list)
    uplink_bits: List[float] = dataclasses.field(default_factory=list)
    weight_sums: List[float] = dataclasses.field(default_factory=list)
    reopt_rounds: List[int] = dataclasses.field(default_factory=list)
    est_p_err: List[float] = dataclasses.field(default_factory=list)
    S_est: List[float] = dataclasses.field(default_factory=list)
    S_true: List[float] = dataclasses.field(default_factory=list)

    def to_dict(self):
        return dataclasses.asdict(self)


class MetricsSink:
    """Sink protocol: receives event dicts, flushes on demand."""

    def emit(self, event: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class MemorySink(MetricsSink):
    """Keep events in-process."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["event"] == kind]


class JsonlSink(MetricsSink):
    """Append-only JSONL event log, written ``buffer`` events at a time.

    ``resume=True`` appends to an existing file: events the prior run
    emitted after the restored checkpoint stay in it, so the stream is
    at-least-once across a resume; readers take the last ``seq`` per
    ``(event, round)``.
    """

    def __init__(self, path, buffer: int = 256, resume: bool = False):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._buf: List[str] = []
        self._buffer = max(1, int(buffer))
        if not (resume and self.path.exists()):
            self.path.write_text("")

    def emit(self, event: Dict[str, Any]) -> None:
        self._buf.append(json.dumps(event, separators=(",", ":")))
        if len(self._buf) >= self._buffer:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            with self.path.open("a") as f:
                f.write("\n".join(self._buf) + "\n")
            self._buf.clear()

    @staticmethod
    def load(path) -> List[Dict[str, Any]]:
        """Read an ``events.jsonl`` back into a list of dicts."""
        return [json.loads(line) for line in pathlib.Path(path).read_text().splitlines()
                if line.strip()]


class CsvSummarySink(MetricsSink):
    """Per-round scalar summary table (``rounds.csv``)."""

    _COLS = ("round", "loss", "participation", "uplink_bits", "weight_sum", "weight_drift")

    def __init__(self, path, resume: bool = False):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._rows: List[str] = [",".join(self._COLS)]
        if resume and self.path.exists():
            rows = self.path.read_text().splitlines()
            if rows and rows[0] == self._rows[0]:
                self._rows = rows

    def emit(self, event: Dict[str, Any]) -> None:
        if event.get("event") != "round":
            return
        self._rows.append(",".join(
            repr(event[c]) if isinstance(event.get(c), float) else str(event.get(c, ""))
            for c in self._COLS))

    def trim_rounds_after(self, r: int) -> None:
        """Drop the rows past round ``r``: rounds the prior run logged after
        the checkpoint being resumed, which are trained and logged again."""
        self._rows = [self._rows[0]] + [row for row in self._rows[1:]
                                        if row and int(row.split(",", 1)[0]) <= r]

    def flush(self) -> None:
        self.path.write_text("\n".join(self._rows) + "\n")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MetricsLogger:
    """The one metric append path (see the module docstring).

    ``log`` is the :class:`TrainLog` facade; ``round_metrics`` holds every
    scalar a round returns, by key, one float a round; ``sinks`` receive
    the event stream.  With no sinks the logger costs one copy to the host
    a round or chunk.
    """

    def __init__(self, sinks: Sequence[MetricsSink] = (), log: Optional[TrainLog] = None):
        self.log = log if log is not None else TrainLog()
        self.sinks = list(sinks)
        self.round_metrics: Dict[str, List[float]] = {}
        self._seq = 0  # monotonic event index across every kind
        self._vectors: Dict[str, List[np.ndarray]] = {}

    # -- event plumbing ------------------------------------------------
    def emit(self, kind: str, **payload: Any) -> None:
        event = {"event": kind, "seq": self._seq, **payload}
        self._seq += 1
        for s in self.sinks:
            s.emit(event)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        self._emit_client_summary()
        for s in self.sinks:
            s.close()

    # -- checkpoint/resume ---------------------------------------------
    def checkpoint_state(self) -> Dict[str, Any]:
        """The ``seq`` cursor, the TrainLog facade, ``round_metrics`` and
        the accumulated vector histories."""
        return {
            "seq": int(self._seq),
            "log": dataclasses.asdict(self.log),
            "round_metrics": {k: list(v) for k, v in self.round_metrics.items()},
            "vectors": {k: np.concatenate(v, axis=0) for k, v in self._vectors.items() if v},
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Reinstate a checkpointed stream position.  The TrainLog lists are
        written in place, so every alias of ``log`` sees the restored
        history; sinks that can rewind drop the rows the prior run logged
        past the checkpoint."""
        self._seq = int(state["seq"])
        for name, vals in state["log"].items():
            getattr(self.log, name)[:] = list(vals)
        self.round_metrics = {k: list(v) for k, v in state["round_metrics"].items()}
        self._vectors = {k: [np.asarray(v)] for k, v in state["vectors"].items()}
        last = self.log.rounds[-1] if self.log.rounds else -1
        for s in self.sinks:
            trim = getattr(s, "trim_rounds_after", None)
            if trim is not None:
                trim(last)

    # -- the round append path -----------------------------------------
    def log_rounds(self, r0: int, metrics: Dict[str, Any], k: int = 1) -> None:
        """Append ``k`` rounds' metrics from round ``r0`` on.

        ``metrics`` holds tensors (or numpy arrays): scalars 0-d (``k ==
        1``) or ``(k,)``, the vectors ``(n,)`` or ``(k, n)``.  The scalars
        come to the host in one copy and widen from float32 to float64, the
        one cast of every stream whichever path ran the rounds.
        """
        names = [m for m in metrics if m not in VECTOR_METRICS]
        stacked = torch.stack([torch.as_tensor(metrics[m]).reshape(k) for m in names])
        values = dict(zip(names, _host(stacked).astype(np.float64).tolist()))
        rounds = list(range(r0, r0 + k))
        self.log.rounds.extend(rounds)
        for name, vals in values.items():
            self.round_metrics.setdefault(name, []).extend(vals)
            field = SCALAR_STREAMS.get(name)
            if field is not None:
                getattr(self.log, field).extend(vals)
        for name in VECTOR_METRICS:
            if name in metrics:
                self._vectors.setdefault(name, []).append(_host(metrics[name]).reshape(k, -1))
        # a non-finite loss still lands in the facade, and is flagged
        for i, lv in enumerate(values.get("loss", ())):
            if not np.isfinite(lv):
                self.emit("health.nan", round=r0 + i, loss=lv)
        if self.sinks:
            streams = [m for m in SCALAR_STREAMS if m in values]
            for i, r in enumerate(rounds):
                self.emit("round", round=r, **{m: values[m][i] for m in streams})

    # -- other streams ---------------------------------------------------
    def log_eval(self, r: int, eval_metrics: Dict[str, float]) -> None:
        em = {key: float(v) for key, v in eval_metrics.items()}
        self.log.eval_rounds.append(r)
        self.log.eval_metrics.append(em)
        self.emit("eval", round=r, **em)

    def log_reopt(self, r: int, *, S_est: float, S_true: float, p_err: float) -> None:
        self.log.reopt_rounds.append(r)
        self.log.est_p_err.append(p_err)
        self.log.S_est.append(S_est)
        self.log.S_true.append(S_true)
        self.emit("reopt", round=r, S_est=S_est, S_true=S_true, p_err=p_err)

    def log_timing(self, r0: int, rounds: int, seconds: float) -> None:
        self.emit("timing", round0=r0, rounds=rounds, seconds=seconds,
                  rounds_per_sec=rounds / seconds if seconds > 0 else 0.0)

    def log_recompiles(self, grew: Dict[str, int], r: int) -> None:
        for name, growth in grew.items():
            self.emit("health.recompile", round=r, fn=name, growth=growth)

    # -- vector metric access --------------------------------------------
    def vector(self, name: str) -> Optional[np.ndarray]:
        """Stacked ``(R, n)`` history of a vector metric (None when the
        stream was never produced: telemetry off)."""
        parts = self._vectors.get(name)
        return np.concatenate(parts, axis=0) if parts else None

    def save_vectors(self, path) -> Optional[pathlib.Path]:
        """Every vector stream into one ``.npz``; the path, or None when
        there is no vector stream."""
        arrays = {name: self.vector(name) for name in self._vectors}
        if not arrays:
            return None
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, **arrays)
        return p

    def _emit_client_summary(self) -> None:
        """End-of-run per-client aggregates as one ``summary.clients``
        event: participation counts and rates, bits-on-air totals, longest
        outage streaks."""
        part = self.vector("client_participation")
        if part is None or not self.sinks:
            return
        bits = self.vector("client_uplink_bits")
        streak = self.vector("outage_streak")
        self.emit(
            "summary.clients",
            rounds=int(part.shape[0]),
            participation_count=part.sum(axis=0).astype(int).tolist(),
            participation_rate=part.mean(axis=0).round(6).tolist(),
            uplink_bits_total=bits.sum(axis=0).tolist() if bits is not None else None,
            outage_streak_max=(streak.max(axis=0).astype(int).tolist()
                               if streak is not None else None),
        )

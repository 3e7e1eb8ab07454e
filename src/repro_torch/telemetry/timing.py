"""Timing, throughput and profiling instrumentation.

The port of ``repro.telemetry.timing``; three host-side probes, all safe
to leave attached:

* :class:`ThroughputMeter` — per-round or per-chunk wall clock, fenced
  with ``torch.cuda.synchronize`` when the fence is on the card (CUDA
  launches return before the device finishes, so an unfenced clock
  measures the enqueue);
* :class:`CompileTracker` — counts the captures of the chunked engine
  (``ScanRound.stats["captures"]``) and reports growth: a round captured
  again in steady state is a regression the ``health.recompile`` event
  names;
* :class:`ProfileWindow` — a ``torch.profiler`` window over rounds
  ``[start, start + rounds)``, opened and closed on round or chunk
  boundaries, written as a Chrome trace into ``profile_dir``.
"""

from __future__ import annotations

import pathlib
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree

__all__ = ["ThroughputMeter", "CompileTracker", "ProfileWindow", "fence_devices"]


def fence_devices(value: Any) -> None:
    """Wait for the CUDA devices that hold any tensor of ``value``."""
    devices = {x.device for x in tree.leaves(value)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class ThroughputMeter:
    """Wall-clock rounds/s with device fencing::

        meter.start()
        ... launch the round or chunk (and the host's prefetch) ...
        dt = meter.stop(rounds=k, fence=metrics)

    ``fence`` (the metrics the caller reads next) is waited for before the
    clock stops, so the interval covers the device's work.
    """

    def __init__(self):
        self._t0: Optional[float] = None
        self.chunks: List[Dict[str, float]] = []
        self.total_rounds = 0
        self.total_seconds = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, rounds: int, fence: Any = None) -> float:
        """Fence, stop the clock, record; returns the elapsed seconds."""
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop() without start()")
        if fence is not None:
            fence_devices(fence)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.chunks.append({"rounds": rounds, "seconds": dt,
                            "rounds_per_sec": rounds / dt if dt > 0 else 0.0})
        self.total_rounds += rounds
        self.total_seconds += dt
        return dt

    def rounds_per_sec(self) -> float:
        """Cumulative throughput over every recorded block."""
        return self.total_rounds / self.total_seconds if self.total_seconds > 0 else 0.0


class CompileTracker:
    """Detect captures of registered chunked engines.

    ``register(name, fn)`` snapshots the engine's capture count (its
    ``stats["captures"]``); ``check()`` returns ``{name: growth}`` for each
    engine that captured since the last call.  On the CPU the engine runs
    its round eagerly and never captures.
    """

    def __init__(self):
        self._fns: Dict[str, Any] = {}
        self._seen: Dict[str, int] = {}

    @staticmethod
    def _size(fn) -> int:
        return int(fn.stats.get("captures", 0))

    def register(self, name: str, fn) -> None:
        self._fns[name] = fn
        self._seen[name] = self._size(fn)

    def compile_counts(self) -> Dict[str, int]:
        """Captures so far per registered engine."""
        return {n: self._size(f) for n, f in self._fns.items()}

    def check(self) -> Dict[str, int]:
        """Capture growth per engine since the previous ``check()``."""
        grew: Dict[str, int] = {}
        for name, fn in self._fns.items():
            size = self._size(fn)
            if size > self._seen[name]:
                grew[name] = size - self._seen[name]
            self._seen[name] = size
        return grew


class ProfileWindow:
    """A ``torch.profiler`` capture over rounds ``[start, start + rounds)``.

    The trainer calls ``maybe_start(r)`` before a round or chunk that
    begins at round ``r`` and ``maybe_stop(r_next)`` after fencing the one
    that ends before ``r_next``; a chunked run profiles whole chunks.  On
    closing, the window writes ``trace.json`` (Chrome trace format) into
    ``profile_dir``; ``close()`` ends a window left open at the run's end.
    """

    def __init__(self, profile_dir: str, start: int = 0, rounds: int = 1):
        if rounds <= 0:
            raise ValueError("profile window needs rounds >= 1")
        self.profile_dir = str(profile_dir)
        self.start = int(start)
        self.rounds = int(rounds)
        self.active = False
        self.done = False
        self.trace_path: Optional[pathlib.Path] = None
        self._prof = None

    def maybe_start(self, r: int) -> bool:
        """Open the window when the block starting at round ``r`` enters
        it; returns True while capturing."""
        if self.active:
            return True
        if not self.done and r >= self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self.active = True
        return self.active

    def maybe_stop(self, r_next: int) -> bool:
        """Close the window once execution has passed its end (``r_next``:
        the first round not yet run)."""
        if self.active and r_next >= self.start + self.rounds:
            self.close()
        return self.done

    def close(self) -> None:
        if not self.active:
            return
        self._prof.__exit__(None, None, None)
        out = pathlib.Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.trace_path = out / "trace.json"
        self._prof.export_chrome_trace(str(self.trace_path))
        self._prof = None
        self.active = False
        self.done = True

"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over one call
of the trainer that runs whole chunks, as the window's call does, reduced to
what the per-layer readers read.

The profiler records the host (the harness's ``bench.call`` span around the
call, the aten ops and the CUDA runtime calls) and the device (every kernel,
copy and fill).  Timestamps of both are on one clock.  A kernel launched by
a ``cudaGraphLaunch`` carries that launch's correlation id; the call makes
one graph launch a round, so the i-th launch belongs to chunk ``i // K``.
The segment runs from the first replayed kernel of the first chunk to the
last of the last: the steady state of a long run, in which the host stacks
each chunk's batches while the device replays the one before, and not the
call's first stack, which a run of many chunks pays once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Kernel", "TraceView", "record", "breakdown", "union_length", "idle_intervals"]

_NAME_CHARS = 160


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    start: int  # ns
    end: int  # ns
    corr: int
    graph_chunk: Optional[int]  # the chunk whose graph launch ran it; None outside a graph


@dataclasses.dataclass
class TraceView:
    """What the readers see of one traced segment."""

    kernels: List[Kernel]  # device kernels (not copies or fills)
    device: List[Tuple[int, int]]  # every device activity, kernels, copies and fills
    copies: List[Tuple[str, int, int]]  # device copies and fills
    chunks: List[Tuple[int, int]]  # each chunk's replays on the device, ns
    host_ops: List[Tuple[str, int, int]]  # the host's aten ops and runtime calls
    rounds: int  # rounds replayed in the segment
    window: Tuple[int, int]  # first chunk's start to the last chunk's end, ns
    cell: Dict[str, object] = dataclasses.field(default_factory=dict)
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return union_length(self.device, self.window) * 1e-9

    def graph_kernels(self) -> List[Kernel]:
        return [k for k in self.kernels if k.graph_chunk is not None]


def union_length(intervals, window: Tuple[int, int]) -> int:
    """Length of the union of ``intervals`` inside ``window``."""
    total, cur_s, cur_e = 0, None, None
    lo, hi = window
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_intervals(intervals, window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The stretches of ``window`` that no interval covers."""
    out, at = [], window[0]
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, window[1])))
        at = max(at, e)
        if at >= window[1]:
            break
    if at < window[1]:
        out.append((at, window[1]))
    return [(s, e) for s, e in out if e > s]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def record(run_call: Callable[[], None], n_chunks: int, rounds_per_chunk: int,
           device_sync: Callable[[], None]) -> TraceView:
    """Profile ``run_call``, one call of the trainer over ``n_chunks`` chunks
    of ``rounds_per_chunk`` rounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    device_sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.call"):
            run_call()
        device_sync()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host_ops: List[Tuple[str, int, int]] = []
    launches: List[Tuple[int, int]] = []  # (host start, correlation id) of graph launches
    raw_device = []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            # the profiler mirrors a host annotation onto the device's
            # timeline; it is no device activity
            if not name.startswith("bench."):
                raw_device.append((name, start, end, e.correlation_id()))
            continue
        if name != "bench.call":
            host_ops.append((name, start, end))
            if name.startswith("cudaGraphLaunch"):
                launches.append((start, e.correlation_id()))
    if len(launches) != n_chunks * rounds_per_chunk:
        raise RuntimeError(f"the profiler recorded {len(launches)} graph launches for "
                           f"{n_chunks} chunks of {rounds_per_chunk} rounds")
    graph_corr = {corr: i // rounds_per_chunk for i, (_, corr) in enumerate(sorted(launches))}
    kernels, copies, device = [], [], []
    for name, s, e, corr in raw_device:
        device.append((s, e))
        if _is_copy(name):
            copies.append((name[:_NAME_CHARS], s, e))
        else:
            kernels.append(Kernel(name[:_NAME_CHARS], s, e, corr, graph_corr.get(corr)))
    kernels.sort(key=lambda k: k.start)
    host_ops.sort(key=lambda h: h[1])
    chunks = []
    for c in range(n_chunks):
        ks = [k for k in kernels if k.graph_chunk == c]
        if not ks:
            raise RuntimeError(f"no replayed kernel of chunk {c} in the trace")
        chunks.append((ks[0].start, max(k.end for k in ks)))
    return TraceView(kernels=kernels, device=device, copies=copies, chunks=chunks,
                     host_ops=host_ops, rounds=n_chunks * rounds_per_chunk,
                     window=(chunks[0][0], chunks[-1][1]))


def breakdown(view: TraceView, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps,
    each named by where it lies (in a chunk's replays, or between two
    chunks) and the innermost host op under way at the gap's middle."""
    by_name: Dict[str, int] = {}
    for k in view.kernels:
        by_name[k.name] = by_name.get(k.name, 0) + (k.end - k.start)
    for name, s, e in view.copies:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_intervals(view.device, view.window), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        span = "in a chunk" if any(a <= mid <= b for a, b in view.chunks) else "between chunks"
        inner = [h for h in view.host_ops if h[1] <= mid <= h[2]]
        op = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "no host op"
        named.append([f"{span} / {op}"[:_NAME_CHARS], (e - s) * 1e-9])
    return {"device_ops": [[n, t * 1e-9] for n, t in ops], "idle_gaps": named}

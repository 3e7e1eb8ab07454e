"""Asynchronous checkpoint writer with a checksummed commit protocol.

The port of ``repro.ckpt.writer``.  A save is split in two so the device's
next chunk and the checkpoint's I/O overlap:

1. **snapshot** (the caller's thread, at a round or chunk boundary): every
   CUDA tensor of the state is copied into pinned host memory,
   asynchronously, on the caller's stream, and an event is recorded after
   the copies; CPU tensors, host containers and numpy arrays are copied
   at once.  The copies are not optional: the chunked engine returns its
   static buffers as the carry and overwrites them in place on the next
   chunk (and the memory strategy's kernel paths and the segmented async
   path do the same with their buffers), so a snapshot must own its
   storage; on the caller's stream the copies come before anything it
   launches later.  The loop does not wait for them.
2. **write** (a background thread): wait for the event, serialize with
   :mod:`repro_torch.checkpoint.io` (``torch.save``), hash (sha256) and
   commit atomically.

Sharded state (the reference's per-shard path): a DTensor leaf becomes a
record of its dtype, its global shape and this rank's shard with its
``start``/``stop`` bounds, the shard copied as above from ``to_local()``.
A shard replicated over a mesh dim is written once, by the rank at
coordinate 0 of that dim.  Nothing gathers: a client-sharded ``(n, d)``
stack is written shard by shard.  A leaf with a pending partial sum is
refused.  :func:`read_state` reassembles whole CPU tensors from the
records; ``launch.steps.place`` lays them out on a mesh again.

Commit protocol: the payload is written to a temp file and renamed to
``ckpt_<step>.pt``; only then is the ``.sha256`` sidecar renamed into
place.  A checkpoint exists iff its sidecar exists, so a crash mid-write
leaves at most an ignored orphan payload.  In a process group of ``W >
1`` ranks each rank writes its own ``ckpt_<step>.rank<r>of<W>.pt`` and
sidecar, and the step exists iff all ``W`` sidecars do.  ``read_state``
hashes each payload again and refuses a mismatch.  After each commit,
retention deletes the committed checkpoints beyond ``keep`` (sidecar
first, which un-commits the payload; in a group each rank its own files).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.dist.layout import is_dtensor

__all__ = ["snapshot", "write_state", "read_state", "CheckpointWriter", "AsyncCheckpointer"]

_STEP_RE = re.compile(r"^ckpt_(\d{8})(?:\.rank(\d+)of(\d+))?\.pt$")
_SHARDED = "__sharded__"


@dataclasses.dataclass
class Snapshot:
    """A state tree that owns its storage, on the host: the copies of CUDA
    tensors are complete once each CUDA device's event has."""

    tree: Any
    events: Dict[torch.device, Any]


def _host_copy(t: torch.Tensor, devices: set) -> torch.Tensor:
    if t.device.type != "cuda":
        return t.detach().clone()
    devices.add(t.device)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t.detach(), non_blocking=True)


def _shard_record(x, devices: set, path: str) -> Dict[str, Any]:
    """A DTensor as its dtype, global shape and this rank's shard with the
    shard's bounds; no shard where a replicated mesh dim's coordinate is
    not 0 (another rank writes that copy)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"checkpoint leaf {path or '<root>'} holds a pending partial sum "
                         f"({x.placements}): settle it before saving")
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    shards = []
    if coord is not None and all(c == 0 for c, p in zip(coord, x.placements)
                                 if p.is_replicate()):
        shape, start = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
        shards.append({"start": list(start), "stop": [a + n for a, n in zip(start, shape)],
                       "data": _host_copy(x.to_local(), devices)})
    return {_SHARDED: 1, "dtype": str(x.dtype).removeprefix("torch."), "shape": list(x.shape),
            "shards": shards}


def _copy(tree: Any, devices: set, path: str = "") -> Any:
    if is_dtensor(tree):
        return _shard_record(tree, devices, path)
    if isinstance(tree, torch.Tensor):
        return _host_copy(tree, devices)
    if isinstance(tree, dict):
        return {k: _copy(v, devices, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_copy(v, devices, f"{path}/{i}") for i, v in enumerate(tree)]
        return t if isinstance(tree, list) else tuple(t)
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    return tree


def _merge(trees: Sequence[Any]) -> Any:
    """The ranks' decoded payloads as one tree: each sharded record with
    every rank's shards, every other leaf as the first rank has it."""
    first = trees[0]
    if isinstance(first, dict):
        if _SHARDED in first:
            return dict(first, shards=[sh for t in trees for sh in t["shards"]])
        return {k: _merge([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_merge([t[i] for t in trees]) for i in range(len(first))]
        return out if isinstance(first, list) else tuple(out)
    return first


def _reassemble(tree: Any, path: str = "") -> Any:
    """Whole CPU tensors rebuilt from the sharded records."""
    if isinstance(tree, dict):
        if _SHARDED in tree:
            out = torch.empty(tree["shape"], dtype=getattr(torch, tree["dtype"]))
            covered = 0
            for sh in tree["shards"]:
                out[tuple(slice(a, b) for a, b in zip(sh["start"], sh["stop"]))] = sh["data"]
                covered += sh["data"].numel()
            if covered != out.numel():
                raise ValueError(f"checkpoint leaf {path or '<root>'}: its shards cover "
                                 f"{covered} of {out.numel()} elements (a rank's file missing?)")
            return out
        return {k: _reassemble(v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_reassemble(v, f"{path}/{i}") for i, v in enumerate(tree)]
        return t if isinstance(tree, list) else tuple(t)
    return tree


def snapshot(tree: Any) -> Snapshot:
    """Capture a state tree: asynchronous copies of its CUDA tensors (a
    DTensor's local shard, as a sharded record) into pinned host memory
    (on the caller's stream, so they read the state before anything
    launched later writes it) and copies of the rest.  No host-device
    sync and no collective."""
    devices: set = set()
    copied = _copy(tree, devices)
    events = {}
    for dev in devices:
        events[dev] = torch.cuda.Event()
        events[dev].record(torch.cuda.current_stream(dev))
    return Snapshot(copied, events)


def _sha_path(path: pathlib.Path) -> pathlib.Path:
    return path.with_suffix(path.suffix + ".sha256")


def write_state(path, tree: Any) -> int:
    """Serialize one state tree (or a :class:`Snapshot` of it) to ``path``
    with the commit protocol: payload rename, then checksum sidecar
    rename.  Returns the payload's bytes."""
    path = pathlib.Path(path)
    snap = tree if isinstance(tree, Snapshot) else snapshot(tree)
    for ev in snap.events.values():  # the copies to the host are complete
        ev.synchronize()
    payload = ckpt_io.to_bytes(snap.tree)
    digest = hashlib.sha256(payload).hexdigest()
    ckpt_io.atomic_write(path, payload)
    ckpt_io.atomic_write(_sha_path(path), f"{digest}  {path.name}\n".encode())
    return len(payload)


def _read_one(path: pathlib.Path) -> Any:
    payload = path.read_bytes()
    sha = _sha_path(path)
    if sha.exists():
        want = sha.read_text().split()[0]
        got = hashlib.sha256(payload).hexdigest()
        if got != want:
            raise ValueError(f"checkpoint {path} is corrupt: sha256 {got[:12]}... != "
                             f"recorded {want[:12]}...")
    return ckpt_io.from_bytes(payload)


def read_state(path: Union[str, os.PathLike, Sequence]) -> Any:
    """Load and verify one committed checkpoint file, or the files of every
    rank of a sharded one; tensors come back whole on the CPU, reassembled
    from their shards."""
    paths = [path] if isinstance(path, (str, os.PathLike)) else list(path)
    return _reassemble(_merge([_read_one(pathlib.Path(p)) for p in paths]))


def _process_rank() -> Tuple[int, int]:
    """This process's ``(rank, world size)`` in the default process group;
    ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointWriter:
    """Synchronous step-indexed checkpoint directory with retention.

    Files are ``ckpt_<step:08d>.pt`` with a ``.sha256`` sidecar; a step is
    committed iff its sidecar exists.  In a default process group of
    ``W > 1`` ranks this rank writes ``ckpt_<step:08d>.rank<r>of<W>.pt``,
    and a step is committed iff the sidecars of all ``W`` ranks exist.  ``save`` commits a step, then
    deletes this rank's files of its steps beyond ``keep`` (newest kept;
    ``keep <= 0`` keeps everything).
    """

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.keep = int(keep)
        self.rank, self.world = _process_rank()

    def _name(self, step: int, rank: int, world: int) -> pathlib.Path:
        tail = "" if world == 1 else f".rank{rank}of{world}"
        return self.dir / f"ckpt_{int(step):08d}{tail}.pt"

    def path_for(self, step: int) -> pathlib.Path:
        """This rank's payload of ``step``."""
        return self._name(step, self.rank, self.world)

    def _committed(self) -> Dict[int, List[pathlib.Path]]:
        """Each committed step's payloads, in rank order."""
        if not self.dir.is_dir():
            return {}
        seen: Dict[Tuple[int, int], set] = {}
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and _sha_path(p).exists():
                world = int(m.group(3) or 1)
                seen.setdefault((int(m.group(1)), world), set()).add(int(m.group(2) or 0))
        return {step: [self._name(step, r, world) for r in range(world)]
                for (step, world), ranks in sorted(seen.items()) if len(ranks) == world}

    def steps(self) -> List[int]:
        return sorted(self._committed())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> int:
        """Commit ``step``; returns the payload's bytes."""
        n_bytes = write_state(self.path_for(step), tree)
        self._gc()
        return n_bytes

    def load(self, step: Optional[int] = None) -> Any:
        """A committed step (the latest by default), whole, on the CPU."""
        committed = self._committed()
        if step is None:
            if not committed:
                raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
            step = max(committed)
        if step not in committed:
            raise FileNotFoundError(f"step {step} is not committed in {self.dir}")
        return read_state(committed[step])

    def _gc(self) -> None:
        # by this rank's own sidecars: in a group another rank may be a save
        # behind, or may already have un-committed an old step
        if self.keep <= 0:
            return
        own = sorted(int(m.group(1)) for p in self.dir.iterdir()
                     if (m := _STEP_RE.match(p.name)) and p == self.path_for(int(m.group(1)))
                     and _sha_path(p).exists())
        for step in own[:-self.keep]:
            p = self.path_for(step)
            _sha_path(p).unlink(missing_ok=True)  # un-commit first
            p.unlink(missing_ok=True)


_STOP = object()


class AsyncCheckpointer:
    """Background-thread checkpointing over a :class:`CheckpointWriter`.

    ``save(step, tree)`` snapshots on the caller's thread and returns;
    the wait for the host copies, serialization, hashing, the atomic commit
    and the retention run on one daemon thread, overlapped with what the caller
    does next.  ``wait()`` drains the queue and raises a writer-side
    failure; ``close()`` drains and stops the thread.  Saves commit in
    submission order.  ``records`` holds one dict a save: its ``step``,
    ``snapshot_s`` (the caller's seconds in :func:`snapshot`), and once
    committed ``commit_s`` (the writer's seconds) and ``bytes``.
    """

    def __init__(self, directory, keep: int = 3):
        self.writer = CheckpointWriter(directory, keep=keep)
        self.records: List[Dict[str, Any]] = []
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._worker.start()

    def _run(self) -> None:
        try:
            # Linux nice() is per thread: the writer fills the host's gaps
            # instead of competing with the thread that launches the rounds
            os.nice(10)
        except OSError:
            pass
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                step, snap, record = item
                t0 = time.perf_counter()
                record["bytes"] = self.writer.save(step, snap)
                record["commit_s"] = time.perf_counter() - t0
            except BaseException as e:  # raised again at the next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, step: int, tree: Any) -> Dict[str, Any]:
        """Snapshot now, write in the background; returns the save's record."""
        self._raise_pending()
        if not self._worker.is_alive():
            raise RuntimeError("AsyncCheckpointer is closed")
        t0 = time.perf_counter()
        snap = snapshot(tree)
        record = {"step": int(step), "snapshot_s": time.perf_counter() - t0}
        self.records.append(record)
        self._q.put((int(step), snap, record))
        return record

    def wait(self) -> None:
        """Block until every queued save has committed."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._worker.is_alive():
            self._q.put(_STOP)
            self._worker.join()
        self._raise_pending()

    def load(self, step: Optional[int] = None) -> Any:
        self.wait()
        return self.writer.load(step)

    def latest_step(self) -> Optional[int]:
        return self.writer.latest_step()

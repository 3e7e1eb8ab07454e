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

Commit protocol: the payload is written to a temp file and renamed to
``ckpt_<step>.pt``; only then is the ``.sha256`` sidecar renamed into
place.  A checkpoint exists iff its sidecar exists, so a crash mid-write
leaves at most an ignored orphan payload.  ``read_state`` hashes the
payload again and refuses a mismatch.  After each commit, retention
deletes the committed checkpoints beyond ``keep`` (sidecar first, which
un-commits the payload).
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
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io

__all__ = ["snapshot", "write_state", "read_state", "CheckpointWriter", "AsyncCheckpointer"]

_STEP_RE = re.compile(r"^ckpt_(\d{8})\.pt$")


@dataclasses.dataclass
class Snapshot:
    """A state tree that owns its storage, on the host: the copies of CUDA
    tensors are complete once each CUDA device's event has."""

    tree: Any
    events: Dict[torch.device, Any]


def _copy(tree: Any, devices: set) -> Any:
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "cuda":
            return tree.detach().clone()
        devices.add(tree.device)
        host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        return host.copy_(tree.detach(), non_blocking=True)
    if isinstance(tree, dict):
        return {k: _copy(v, devices) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_copy(v, devices) for v in tree]
        return t if isinstance(tree, list) else tuple(t)
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    return tree


def snapshot(tree: Any) -> Snapshot:
    """Capture a state tree: asynchronous copies of its CUDA tensors into
    pinned host memory (on the caller's stream, so they read the state
    before anything launched later writes it) and copies of the rest.  No
    host-device sync."""
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


def read_state(path) -> Any:
    """Load and verify one committed checkpoint file; tensors come back on
    the CPU."""
    path = pathlib.Path(path)
    payload = path.read_bytes()
    sha = _sha_path(path)
    if sha.exists():
        want = sha.read_text().split()[0]
        got = hashlib.sha256(payload).hexdigest()
        if got != want:
            raise ValueError(f"checkpoint {path} is corrupt: sha256 {got[:12]}... != "
                             f"recorded {want[:12]}...")
    return ckpt_io.from_bytes(payload)


class CheckpointWriter:
    """Synchronous step-indexed checkpoint directory with retention.

    Files are ``ckpt_<step:08d>.pt`` with a ``.sha256`` sidecar; a step is
    committed iff its sidecar exists.  ``save`` commits a step, then
    deletes the committed steps beyond ``keep`` (newest kept; ``keep <=
    0`` keeps everything).
    """

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.keep = int(keep)

    def path_for(self, step: int) -> pathlib.Path:
        return self.dir / f"ckpt_{int(step):08d}.pt"

    def steps(self) -> List[int]:
        if not self.dir.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.dir.iterdir()
                      if (m := _STEP_RE.match(p.name)) and _sha_path(p).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> int:
        """Commit ``step``; returns the payload's bytes."""
        n_bytes = write_state(self.path_for(step), tree)
        self._gc()
        return n_bytes

    def load(self, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return read_state(self.path_for(step))

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for step in self.steps()[:-self.keep]:
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

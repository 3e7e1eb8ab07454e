"""Checkpoint files for nested dict/list/tuple trees of tensors.

The port of ``repro.checkpoint.io``, with one deliberate departure: the
reference packs with ``msgpack``; the port writes with ``torch.save`` and
reads with ``torch.load(..., weights_only=True)``, so a file holds tensors
(bfloat16 natively) and plain Python values only and loading it runs no
code.  Dicts, lists and tuples stay apart; ints, floats, strings, bools
and None pass as they are; numpy arrays and scalars travel as tensors
tagged with their dtype (their raw bytes in a uint8 tensor) and come
back as numpy.  The port does not read
the reference's ``.msgpack`` checkpoints.  Writes are atomic (a temp file
renamed into place).
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "to_bytes", "from_bytes"]

_NDARRAY = "__ndarray__"
_SCALARS = (int, float, str, bool, type(None))


def encode(obj: Any) -> Any:
    """The tree with its numpy leaves as tagged tensors; a leaf that is none
    of the supported kinds raises ``TypeError``."""
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(encode(v) for v in obj)
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy()
        return {_NDARRAY: arr.dtype.str, "shape": list(arr.shape),
                "data": torch.from_numpy(raw)}
    if isinstance(obj, _SCALARS):
        return obj
    raise TypeError(f"cannot checkpoint {type(obj)}")


def decode(obj: Any) -> Any:
    """Inverse of :func:`encode`."""
    if isinstance(obj, dict):
        if _NDARRAY in obj:
            raw = obj["data"].numpy()
            return raw.view(np.dtype(obj[_NDARRAY])).reshape(obj["shape"]).copy()
        return {k: decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(decode(v) for v in obj)
    return obj


def to_bytes(tree: Any) -> bytes:
    """The serialized form of ``tree`` (its tensors must be on the CPU)."""
    buf = io.BytesIO()
    torch.save(encode(tree), buf)
    return buf.getvalue()


def from_bytes(payload: bytes) -> Any:
    """Inverse of :func:`to_bytes`; tensors come back on the CPU."""
    return decode(torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True))


def atomic_write(path, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temp file in the same directory,
    renamed into place."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=d, delete=False) as f:
        f.write(data)
        tmp = f.name
    os.replace(tmp, path)


def save_checkpoint(path, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically, its tensors moved to the CPU."""
    atomic_write(path, to_bytes(_cpu(tree)))


def load_checkpoint(path) -> Any:
    with open(path, "rb") as f:
        return from_bytes(f.read())


def _cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_cpu(v) for v in tree]
        return t if isinstance(tree, list) else tuple(t)
    return tree

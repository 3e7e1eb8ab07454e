"""Structured run manifests: what exactly did this run execute?

The port of ``repro.telemetry.manifest``.  A :class:`RunManifest` is
written once at run start (``manifest.json`` beside the metric streams):
the full config with a stable digest, the strategy, channel and codec
names, the torch and CUDA versions, the backend (``"cuda"`` or
``"cpu"``), the device count, the GPU's name and the repo's git SHA.
:func:`config_digest` is the reference's: the same config dict gives the
same digest in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import subprocess
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["RunManifest", "config_digest", "git_sha"]


def _jsonable(obj: Any) -> Any:
    """Canonical JSON form (numpy scalars and arrays, dataclasses,
    mappings); unknown objects fall back to their repr."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "tolist"):  # numpy scalar or array, tensor
        return _jsonable(obj.tolist())
    if hasattr(obj, "item"):
        return obj.item()
    return repr(obj)


def config_digest(config: Dict[str, Any]) -> str:
    """sha256 over the canonical (sorted-key) JSON form of a config dict:
    two runs with the same digest ran the same configuration."""
    canon = json.dumps(_jsonable(config), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """The repo's HEAD SHA, or None outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
                             text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


@dataclasses.dataclass
class RunManifest:
    """One run's provenance record (see the module docstring)."""

    config: Dict[str, Any]
    config_digest: str
    strategy: Optional[str] = None
    channel: Optional[str] = None
    codec: Optional[str] = None
    mesh_shape: Optional[Dict[str, int]] = None
    backend: str = ""
    device_count: int = 0
    torch_version: str = ""
    cuda_version: Optional[str] = None
    git_sha: Optional[str] = None
    created_unix: float = 0.0
    #: the checkpoint this run restored from; None for a run from scratch
    resumed_from: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def collect(cls, config: Dict[str, Any], *, device=None, strategy: Optional[str] = None,
                channel: Optional[str] = None, codec: Optional[str] = None,
                mesh_shape: Optional[Dict[str, int]] = None,
                resumed_from: Optional[str] = None, **extra: Any) -> "RunManifest":
        """Gather the environment's fields around the caller's run identity;
        ``device`` (default: CUDA when present) sets the backend, and on a
        CUDA device ``extra`` records the GPU's name."""
        dev = torch.device(device if device is not None
                           else ("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda":
            extra = {**extra, "gpu": torch.cuda.get_device_name(dev)}
        return cls(
            config=_jsonable(config),
            config_digest=config_digest(config),
            strategy=strategy,
            channel=channel,
            codec=codec,
            mesh_shape=dict(mesh_shape) if mesh_shape else None,
            backend=dev.type,
            device_count=torch.cuda.device_count() if dev.type == "cuda" else 1,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            git_sha=git_sha(cwd=str(pathlib.Path(__file__).parent)),
            created_unix=time.time(),
            resumed_from=str(resumed_from) if resumed_from is not None else None,
            extra=_jsonable(extra),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def write(self, path) -> pathlib.Path:
        """Write ``manifest.json`` (``path`` is the file or a directory to
        put it in); returns the written path."""
        p = pathlib.Path(path)
        if p.is_dir() or p.suffix != ".json":
            p.mkdir(parents=True, exist_ok=True)
            p = p / "manifest.json"
        else:
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_dict(), indent=1, sort_keys=True))
        return p

"""Production and debug meshes, and the client-axis bookkeeping.

The counterpart of ``repro.dist.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims.  The
builders are functions, never module-level constants, and they take the
mesh's device type explicitly: importing this module touches no
``torch.distributed`` state, and the process group is the caller's to set
up before it builds a mesh (a fake group for the dry run, gloo for the CPU
tests, NCCL on the card).

Target layout, as the reference's: a 16 x 16 single-pod mesh ``(data,
model)`` of 256 devices, and a 2 x 16 x 16 mesh ``(pod, data, model)`` of
512.  FL clients map onto the data axes: 16 clients single-pod, 32 (pod x
data) two-pod.

The rules here and in :mod:`repro_torch.launch.sharding` read a mesh only
through :func:`mesh_view`: its ``axis_names`` and its ``shape`` as a dict,
so a duck-typed object with those two attributes stands in for a mesh
without any process group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["MeshView", "mesh_view", "make_production_mesh", "make_debug_mesh", "client_axes",
           "n_clients", "client_axis_spec"]


@dataclasses.dataclass(frozen=True)
class MeshView:
    """A mesh's dim names, in order, and each dim's size by name."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def mesh_view(mesh) -> MeshView:
    """``mesh`` (a named ``DeviceMesh``, a :class:`MeshView`, or anything
    with ``axis_names`` and a ``shape`` dict) as a :class:`MeshView`."""
    if isinstance(mesh, MeshView):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return MeshView(tuple(names), dict(zip(names, mesh.shape)))
    return MeshView(tuple(mesh.axis_names), {a: int(mesh.shape[a]) for a in mesh.axis_names})


def _make_mesh(device_type: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 x 16 ``(data, model)`` mesh, or 2 x 16 x 16 ``(pod, data,
    model)`` with ``multi_pod``, over the default process group (whose
    world size must be 256 or 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2, *, device_type: str = "cuda"):
    """A small ``(data, model)`` mesh for tests (world size ``data * model``)."""
    return _make_mesh(device_type, (data, model), ("data", "model"))


def client_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that enumerate FL clients."""
    return tuple(a for a in mesh_view(mesh).axis_names if a in ("pod", "data"))


def n_clients(mesh) -> int:
    view = mesh_view(mesh)
    n = 1
    for a in client_axes(view):
        n *= view.shape[a]
    return n


def client_axis_spec(mesh):
    """The spec entry of a client-indexed dim: the client axes as a tuple
    when several enumerate clients (two pods), else the one axis name."""
    ca = client_axes(mesh)
    return ca if len(ca) > 1 else ca[0]

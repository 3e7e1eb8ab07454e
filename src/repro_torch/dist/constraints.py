"""Sharding specs and the in-graph constraints the models and the FL round
call.

The counterpart of ``repro.dist.constraints``.  A spec is the reference's
``PartitionSpec``: one entry per tensor dim, each ``None`` (replicated), a
mesh axis name, or a tuple of names (one dim sharded over several mesh
dims, the outer one first, as JAX lays it out).  On a
``torch.distributed`` ``DeviceMesh`` a spec becomes DTensor placements:
an entry on tensor dim ``k`` gives ``Shard(k)`` on each of its mesh dims,
and every other mesh dim is ``Replicate()`` (:meth:`PartitionSpec.placements`).

``constrain_act`` pins the residual stream to ``cfg.act_spec``, a spec
template for the trailing ``(batch, seq, d_model)`` dims set by the launch
layer (:mod:`repro_torch.launch.steps`).  Under an active mesh
(``with use_mesh(mesh):``) a DTensor is redistributed to the spec fitted to
its own mesh; outside a mesh, and for a plain tensor, every hook is the
identity and returns the same object, so the one-device paths run
unchanged.  :func:`_fit_spec` drops any entry whose mesh axes are missing
or whose product does not divide the dim, so one template serves every
(arch x mesh).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch import tree
from repro_torch.dist.layout import is_dtensor
from repro_torch.dist.mesh import mesh_view

__all__ = ["PartitionSpec", "NamedSharding", "use_mesh", "current_mesh", "constrain",
           "constrain_act", "constrain_grads", "spmd_axis_name"]

AxisEntry = Union[None, str, Tuple[str, ...]]
Params = Any


def _entry_axes(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class PartitionSpec(tuple):
    """A spec: a tuple of entries, one per tensor dim."""

    def __new__(cls, *entries: AxisEntry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def placements(self, mesh) -> tuple:
        """The DTensor placements of this spec on ``mesh``, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(mesh_view(mesh).axis_names)
        names = mesh_view(mesh).axis_names
        for k, entry in enumerate(self):
            for a in _entry_axes(entry):
                out[names.index(a)] = Shard(k)
        return tuple(out)

    def shard_shape(self, shape: Sequence[int], mesh) -> Tuple[int, ...]:
        """The per-device shape of a tensor of ``shape`` under this spec."""
        view = mesh_view(mesh)
        out = list(shape)
        for k, entry in enumerate(self):
            for a in _entry_axes(entry):
                out[k] //= view.shape[a]
        return tuple(out)


class NamedSharding:
    """A spec on a mesh: the value every sharding rule returns."""

    def __init__(self, mesh, spec: Sequence[AxisEntry] = ()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)

    def placements(self) -> tuple:
        return self.spec.placements(self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return self.spec.shard_shape(shape, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


_STACK = threading.local()


def _meshes() -> List[Any]:
    if not hasattr(_STACK, "meshes"):
        _STACK.meshes = []
    return _STACK.meshes


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the active mesh inside the block (``None`` leaves the
    block without one): the counterpart of the reference's ``with mesh:``."""
    stack = _meshes()
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh` block, if any."""
    stack = _meshes()
    return stack[-1] if stack else None


def _fit_spec(spec: Sequence[AxisEntry], shape: Tuple[int, ...], mesh) -> Optional[PartitionSpec]:
    """Align ``spec`` to the trailing dims of ``shape``, dropping any entry
    whose mesh axes are missing or whose product does not divide the dim."""
    view = mesh_view(mesh)
    ndim = len(shape)
    if len(spec) > ndim:
        return None
    out: list = [None] * ndim
    off = ndim - len(spec)
    nontrivial = False
    for i, entry in enumerate(spec):
        axes = tuple(a for a in _entry_axes(entry)
                     if a in view.axis_names and view.shape[a] > 1)
        if not axes:
            continue
        size = 1
        for a in axes:
            size *= view.shape[a]
        if shape[off + i] % size != 0:
            continue
        out[off + i] = axes if len(axes) > 1 else axes[0]
        nontrivial = True
    return PartitionSpec(*out) if nontrivial else None


def constrain(x, spec: Sequence[AxisEntry]):
    """``x`` redistributed to ``spec`` (trailing-dim aligned, fitted to its
    own mesh) when a mesh is active and ``x`` is a DTensor; else ``x``."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    p = _fit_spec(tuple(spec), tuple(x.shape), x.device_mesh)
    if p is None:
        return x
    placements = p.placements(x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_act(cfg, x):
    """Residual-stream hook: pin ``x`` to ``cfg.act_spec`` when set."""
    spec = getattr(cfg, "act_spec", None)
    if not spec:
        return x
    return constrain(x, spec)


def constrain_grads(grads: Params, grad_shardings: Optional[Params]) -> Params:
    """A gradient tree of DTensors redistributed to ``grad_shardings`` (a
    tree of :class:`NamedSharding` of the same structure), each on its
    gradient's own mesh; identity without shardings."""
    if grad_shardings is None:
        return grads

    def pin(g, sh):
        if not is_dtensor(g):
            return g
        placements = sh.spec.placements(g.device_mesh)
        if tuple(g.placements) == placements:
            return g
        return g.redistribute(g.device_mesh, placements)

    return tree.map(pin, grads, grad_shardings)


def spmd_axis_name(spmd_axes: Optional[Tuple[str, ...]]):
    """A ``RoundConfig.spmd_axes`` tuple in the reference's normal form:
    None, one name, or a tuple of names."""
    if not spmd_axes:
        return None
    return spmd_axes if len(spmd_axes) > 1 else spmd_axes[0]

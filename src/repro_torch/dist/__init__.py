"""Sharding substrate: mesh topology and the activation/gradient hooks.

The counterpart of ``repro.dist``, on ``torch.distributed``'s
``DeviceMesh`` and DTensor:

* ``mesh`` — the production and debug mesh builders, and the client-axis
  bookkeeping (which mesh axes enumerate FL clients);
* ``constraints`` — the specs and in-graph constraints: the residual-stream
  ``constrain_act`` hook the models call at every block, and the helpers
  :mod:`repro_torch.fl.round` uses for the client axes (``spmd_axis_name``)
  and the gradient tree (``constrain_grads``);
* ``layout`` — the port's own DTensor layout helpers, which close the gaps
  DTensor's per-op partitioning leaves where the models call them.

Everything is the identity outside a mesh (``use_mesh``), so the same
model code runs unchanged on one device and on a mesh.  Importing this
package touches no ``torch.distributed`` state.
"""

from .constraints import (
    NamedSharding,
    PartitionSpec,
    constrain,
    constrain_act,
    constrain_grads,
    current_mesh,
    spmd_axis_name,
    use_mesh,
)
from .mesh import MeshView, client_axes, make_debug_mesh, make_production_mesh, mesh_view, n_clients

__all__ = [
    "constrain",
    "constrain_act",
    "constrain_grads",
    "current_mesh",
    "spmd_axis_name",
    "client_axes",
    "make_debug_mesh",
    "make_production_mesh",
    "n_clients",
    "use_mesh",
    "PartitionSpec",
    "NamedSharding",
    "MeshView",
    "mesh_view",
]

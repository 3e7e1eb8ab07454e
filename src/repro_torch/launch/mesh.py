"""The mesh builders for launch-side callers; they live in
:mod:`repro_torch.dist.mesh` (the counterpart of ``repro.launch.mesh``)."""

from repro_torch.dist.mesh import (  # noqa: F401
    client_axes,
    client_axis_spec,
    make_debug_mesh,
    make_production_mesh,
    n_clients,
)

__all__ = ["client_axes", "client_axis_spec", "make_debug_mesh", "make_production_mesh",
           "n_clients"]

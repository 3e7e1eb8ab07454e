"""Parameters of the JAX reference package, as numpy arrays, into the port.

The port keeps the reference's tree structure, key paths and layouts
(HWIO conv weights, ``(d, H, hd)`` attention projections, stacked layer
axes), so converting is a copy onto the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree

__all__ = ["params_from_jax"]


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    # numpy holds bfloat16 as an extension dtype (ml_dtypes) that
    # torch.from_numpy rejects: carry its 16 bits over unchanged
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree_of_numpy, device) -> object:
    """``jax.tree.map(np.asarray, params)`` -> the same tree of tensors on
    ``device``, in the arrays' own dtypes (bfloat16 bit for bit)."""
    return tree.map(lambda a: _tensor(a).to(device), tree_of_numpy)

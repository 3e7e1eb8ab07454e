"""Parameters of the JAX reference package, as numpy arrays, into the port.

The port keeps the reference's tree structure, key paths and layouts
(HWIO conv weights), so converting is a copy onto the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree

__all__ = ["params_from_jax"]


def params_from_jax(tree_of_numpy, device) -> object:
    """``jax.tree.map(np.asarray, params)`` -> the same tree of tensors on
    ``device``, in the arrays' own dtypes."""
    return tree.map(lambda a: torch.from_numpy(np.array(a)).to(device), tree_of_numpy)

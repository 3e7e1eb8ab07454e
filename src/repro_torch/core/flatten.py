"""Flatten-once plumbing between update trees and the ``(n, d)`` stack.

The round ravels the per-client update tree into one contiguous
``(n_clients, d)`` buffer, streams it through the fused aggregation
kernel once, and unravels the ``(d,)`` PS delta back into the model tree.
Leaf order is :mod:`repro_torch.tree` order (sorted dict keys), so the
columns match ``repro.core.flatten`` one for one.

* :func:`ravel_stacked` allocates the ``(n, d)`` buffer once and copies
  each leaf into its column range, casting per leaf on the way in, so no
  full-size casted copy is made first.
* :func:`ravel` does the same for one tree, ``(d,)``.
* :func:`ravel_stacked_concat` is the concatenating ravel, kept as the
  oracle and the baseline that copies the parts before it concatenates:
  bitwise :func:`ravel_stacked`.
* :func:`ravel_stacked_segments` returns the per-leaf ``(n, d_i)``
  column segments (reshape + cast only); the segment-streaming kernel
  path consumes them and the monolithic stack never exists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

__all__ = [
    "FlatSpec",
    "flat_spec",
    "ravel",
    "ravel_stacked",
    "ravel_stacked_concat",
    "ravel_stacked_segments",
    "unravel",
    "unravel_stacked",
]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a flattened tree: where each leaf lives in (d,)."""

    treedef: tree_util.TreeDef
    shapes: Tuple[Tuple[int, ...], ...]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(int(o) for o in np.cumsum((0,) + self.sizes[:-1]))

    @property
    def d(self) -> int:
        return sum(self.sizes)


def flat_spec(tree: Any, *, stacked: bool = False) -> FlatSpec:
    """Layout spec for ``tree``.  With ``stacked=True`` the leaves carry a
    leading client axis ``(n, *shape)`` that is excluded from the layout."""
    leaves, treedef = tree_util.flatten(tree)
    shapes = tuple(
        tuple(leaf.shape[1:] if stacked else leaf.shape) for leaf in leaves
    )
    return FlatSpec(treedef, shapes)


def ravel(tree: Any, *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Tree -> contiguous ``(d,)`` buffer (leaf order = :mod:`repro_torch.tree`
    order): one preallocated buffer filled leaf by leaf, the cast folded
    into each copy."""
    leaves = tree_util.leaves(tree)
    if len(leaves) == 1:
        return leaves[0].reshape(-1).to(dtype or leaves[0].dtype)
    d = sum(leaf.numel() for leaf in leaves)
    out = torch.empty((d,), dtype=dtype or leaves[0].dtype, device=leaves[0].device)
    offset = 0
    for leaf in leaves:
        out[offset:offset + leaf.numel()].copy_(leaf.reshape(-1))
        offset += leaf.numel()
    return out


def ravel_stacked(tree: Any, *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stacked tree (leaves ``(n, *shape)``) -> contiguous ``(n, d)``: one
    preallocated buffer filled leaf by leaf, the cast folded into each copy."""
    leaves = tree_util.leaves(tree)
    n = leaves[0].shape[0]
    parts = [leaf.reshape(n, -1) for leaf in leaves]
    d = sum(p.shape[1] for p in parts)
    out = torch.empty((n, d), dtype=dtype or parts[0].dtype, device=parts[0].device)
    offset = 0
    for p in parts:
        out[:, offset:offset + p.shape[1]].copy_(p)
        offset += p.shape[1]
    return out


def ravel_stacked_concat(tree: Any, *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The concatenating ravel: each leaf's casted ``(n, d_i)`` part is
    made in full before one ``torch.cat``.  Bitwise :func:`ravel_stacked`;
    the extra copy is what that function saves."""
    leaves = tree_util.leaves(tree)
    n = leaves[0].shape[0]
    parts = [leaf.reshape(n, -1) for leaf in leaves]
    if dtype is not None:
        parts = [p.to(dtype) for p in parts]
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def ravel_stacked_segments(tree: Any, *,
                           dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Stacked tree -> per-leaf contiguous ``(n, d_i)`` column segments in
    spec order; ``torch.cat(segments, 1)`` equals :func:`ravel_stacked`."""
    leaves = tree_util.leaves(tree)
    n = leaves[0].shape[0]
    return [leaf.reshape(n, -1).to(dtype or leaf.dtype).contiguous() for leaf in leaves]


def unravel(spec: FlatSpec, flat: torch.Tensor, *,
            dtype: Optional[torch.dtype] = None) -> Any:
    """(d,) buffer -> tree with ``spec``'s structure and leaf shapes."""
    if tuple(flat.shape) != (spec.d,):
        raise ValueError(f"flat buffer {tuple(flat.shape)} != spec total ({spec.d},)")
    if dtype is not None:
        flat = flat.to(dtype)
    leaves = [flat[o:o + s].reshape(shape)
              for o, s, shape in zip(spec.offsets, spec.sizes, spec.shapes)]
    return tree_util.unflatten(spec.treedef, leaves)


def unravel_stacked(spec: FlatSpec, stack: torch.Tensor, *,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """``(n, d)`` stack -> stacked tree (leaves ``(n, *shape)``); the exact
    inverse of :func:`ravel_stacked` at matching dtype."""
    if stack.ndim != 2 or stack.shape[1] != spec.d:
        raise ValueError(f"stack {tuple(stack.shape)} != (n, {spec.d})")
    n = stack.shape[0]
    if dtype is not None:
        stack = stack.to(dtype)
    leaves = [stack[:, o:o + s].reshape((n,) + shape)
              for o, s, shape in zip(spec.offsets, spec.sizes, spec.shapes)]
    return tree_util.unflatten(spec.treedef, leaves)

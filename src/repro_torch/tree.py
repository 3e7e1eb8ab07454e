"""Pytree helpers over nested dicts, lists and tuples of tensors.

Leaves come out in ``jax.tree`` order: dict keys sorted at every level,
lists and tuples by index.  ``torch.utils._pytree`` keeps dict insertion
order instead, which would lay the ``(n, d)`` update stack out in another
column order than the reference package.  Anything that is not a dict,
list or tuple is a leaf.

The walks are module-level functions that take their output as an
argument: a recursive nested function would sit in a reference cycle with
its closure, and the list of leaves in that closure (a whole params tree)
would outlive the call until the garbage collector's next full pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Tuple

__all__ = ["TreeDef", "flatten", "unflatten", "leaves", "map", "paths", "from_paths"]


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a tree with its leaves taken out."""

    kind: str  # "leaf" | "dict" | "list" | "tuple"
    keys: Tuple[Any, ...] = ()  # sorted dict keys; empty otherwise
    children: Tuple["TreeDef", ...] = ()


_LEAF = TreeDef("leaf")


def _children(tree) -> Tuple[str, Tuple[Any, ...], List[Any]]:
    if isinstance(tree, Mapping):
        keys = tuple(sorted(tree))
        return "dict", keys, [tree[k] for k in keys]
    if isinstance(tree, list):
        return "list", (), list(tree)
    if isinstance(tree, tuple):
        return "tuple", (), list(tree)
    return "leaf", (), []


def _flatten_into(node, out: List[Any]) -> TreeDef:
    kind, keys, kids = _children(node)
    if kind == "leaf":
        out.append(node)
        return _LEAF
    return TreeDef(kind, keys, tuple([_flatten_into(k, out) for k in kids]))


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` with leaves in ``jax.tree.flatten`` order."""
    out: List[Any] = []
    return out, _flatten_into(tree, out)


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, kids))
    return kids if td.kind == "list" else tuple(kids)


def unflatten(treedef: TreeDef, leaves_: List[Any]):
    """Inverse of :func:`flatten`."""
    it = iter(leaves_)
    tree = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return tree


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest):
    """``jax.tree.map``: apply ``fn`` leaf-wise over trees of one structure."""
    flat, td = flatten(tree)
    others = []
    for r in rest:
        rl, rtd = flatten(r)
        if rtd != td:
            raise ValueError("tree structures differ")
        others.append(rl)
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])


def paths(tree) -> List[str]:
    """Dotted key path of every leaf, in leaf order (``"stages.1.0.wproj"``);
    the names ``nn.Module.named_parameters`` gives the same leaves."""
    out: List[str] = []
    _paths_into(tree, "", out)
    return out


def _paths_into(node, prefix: str, out: List[str]) -> None:
    kind, keys, kids = _children(node)
    if kind == "leaf":
        out.append(prefix)
        return
    names = keys if kind == "dict" else range(len(kids))
    for name, kid in zip(names, kids):
        _paths_into(kid, f"{prefix}.{name}" if prefix else str(name), out)


def from_paths(named: Mapping[str, Any]):
    """Nested tree from dotted paths; a level whose keys are all digits
    becomes a list (``"stages.1.0.w1"`` -> ``tree["stages"][1][0]["w1"]``)."""
    root: dict = {}
    for path, value in named.items():
        node = root
        *head, last = path.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)

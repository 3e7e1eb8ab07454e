"""DTensor layout helpers for the port's models and FL round on a mesh.

DTensor (``torch.distributed.tensor``) partitions every op by its own
rules, which leave gaps that XLA's partitioner, the reference's, does not:
a matmul's batch folds a sharded dim only when it is the first of the
folded dims, a pending partial sum is reduced once, a contraction's result
may come back sharded on a dim that the next view cannot split, a
permute's gradient comes back strided.  Each helper here closes one such
gap where the models call it, by a redistribution (which adds the
collective a partitioner would have chosen) or a layout of the gradient.

Every helper is the identity on a plain tensor (and returns the same
object), so the one-device paths run unchanged; none imports
``torch.distributed.tensor`` before a DTensor exists.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["is_dtensor", "shard_ways", "settle", "split_ready", "merge_ready", "fold_ready",
           "gather_clients", "grad_as", "write_at", "vocab_sharded", "pin_like", "distribute",
           "contiguous_strides"]


def is_dtensor(x) -> bool:
    # no DTensor exists unless its module was imported: the one-device
    # paths never import it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _settled(placements) -> tuple:
    """``placements`` with each pending sum read as replicated."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


def shard_ways(x, dim: int) -> int:
    """Into how many shards a DTensor's ``dim`` is cut (1 for a plain tensor)."""
    if not is_dtensor(x):
        return 1
    dim %= x.ndim
    ways = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            ways *= x.device_mesh.size(i)
    return ways


def settle(x, dim: Optional[int] = None):
    """A DTensor with a pending partial sum (a vocab-sharded embedding's
    lookup, a contraction over a sharded dim) reduced: into ``Shard(dim)``
    on that mesh dim when ``dim`` is given and divides there (a
    reduce-scatter), else to ``Replicate()``; else ``x``.  A pending sum
    that two operands of one op share (``x * x``) cannot be reduced twice,
    so the models settle the embedding's output at once."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    placements = []
    for i, p in enumerate(x.placements):
        if not p.is_partial():
            placements.append(p)
        elif dim is not None and x.shape[dim] % (shard_ways(x, dim) * mesh.size(i)) == 0:
            placements.append(Shard(dim % x.ndim))
        else:
            placements.append(Replicate())
    placements = tuple(placements)
    if placements == tuple(x.placements):
        return x
    # the gradient is made whole before it flows back into the reduction,
    # whose backward takes no pending sum
    local = x.redistribute(mesh, placements).to_local(grad_placements=placements)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def split_ready(x, dim: int, lead: int):
    """``x`` ready for a reshape that splits ``dim`` into ``(lead, ...)``:
    a DTensor sharding of ``dim`` over mesh dims whose size does not divide
    ``lead`` replicated first (DTensor cannot split it), else ``x``."""
    if lead % shard_ways(x, dim) == 0:
        return x
    from torch.distributed.tensor import Replicate

    dim %= x.ndim
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_shard(dim) else p for p in x.placements])


def merge_ready(x, ndims: int = 2, start: int = 0):
    """``x`` ready for an op that folds its dims ``start .. start + ndims -
    1`` into one (a projection of ``(B, T, d)`` activations, the ``(H, hd)``
    of a projection's weight): DTensor folds them only when no dim but the
    first is sharded, so the sharding of the others is gathered (for a
    sequence-sharded activation, Megatron's sequence-parallel all-gather
    before a tensor-parallel matmul; for an fsdp-sharded weight, its
    all-gather).  Else ``x``."""
    if not is_dtensor(x) or x.ndim < start + ndims:
        return x
    from torch.distributed.tensor import Replicate

    def folded(p):
        return p.is_shard() and start < p.dim < start + ndims

    if not any(folded(p) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if folded(p) else p for p in x.placements])


def fold_ready(x, dims: Sequence[int]):
    """``x`` ready for a batched matmul that folds ``dims`` into its batch
    dim: DTensor folds two dims sharded over different mesh dims in no
    case, so of ``dims`` only the first sharded one keeps its sharding
    (the batch's, before the heads').  Else ``x``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dims = [d % x.ndim for d in dims]
    sharded = [d for d in dims if shard_ways(x, d) > 1]
    if len(sharded) < 2:
        return x
    drop = set(sharded[1:])
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard() and p.dim in drop else p
                                          for p in x.placements])


def gather_clients(x):
    """A DTensor's shards over the client axes (``pod``, ``data``: the fsdp
    shards of a param) gathered, before the param is used; else ``x``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names or ()
    placements = [Replicate() if p.is_shard() and names[i] in ("pod", "data") else p
                  for i, p in enumerate(x.placements)]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _GradAs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.placements is not None and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.contiguous(), None


def grad_as(x, like=None):
    """``x`` for a DTensor whose gradient will come back in a layout an op
    before it cannot take: the gradient made contiguous (DTensor's
    decompositions view the local tensors they are given, and a permute's
    gradient is strided) and, given ``like``, redistributed to ``like``'s
    placements (a pending sum read as replicated).  Else ``x``."""
    if not (is_dtensor(x) and x.requires_grad):
        return x
    return _GradAs.apply(x, None if like is None else _settled(like.placements))


def write_at(x, dim: int, index: int, value) -> None:
    """``x[..., index, ...] = value`` along ``dim``, in place.  For a DTensor
    ``x`` the value (laid out as ``x`` without ``dim``) is written into the
    local shard of the rank that holds ``index``; DTensor itself would
    gather ``x`` to write one slice of a sharded dim."""
    if not is_dtensor(x):
        x[(slice(None),) * dim + (index,)] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    vpl = [Replicate() if p.is_shard(dim) else
           Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p for p in x.placements]
    if is_dtensor(value):
        value = value.redistribute(mesh, vpl).to_local()
    lo, size = 0, x.shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            lo += coord[i] * size
    if lo <= index < lo + size:
        x.to_local().select(dim, index - lo).copy_(value)


def vocab_sharded(x) -> bool:
    """Whether ``x`` is a DTensor whose last dim is sharded."""
    return is_dtensor(x) and any(p.is_shard(x.ndim - 1) for p in x.placements)


def pin_like(x, like):
    """``x`` redistributed to the placements of ``like`` (a pending sum of
    ``like`` read as replicated) when both are DTensors on one mesh and the
    placements differ; a DTensor ``x`` made whole when ``like`` is a plain
    tensor; else ``x``."""
    if not is_dtensor(x):
        return x
    if not is_dtensor(like):
        return x.full_tensor()
    target = _settled(like.placements)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(like.device_mesh, target)


def distribute(x, sharding):
    """The DTensor of the whole tensor ``x`` (the same on every rank) under
    ``sharding`` (a :class:`NamedSharding` on a ``DeviceMesh``): this
    rank's chunk of it, cut locally with no communication.  A tensor dim
    sharded over several mesh dims is cut outer mesh dim first."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = sharding.placements()
    coord = mesh.get_coordinate()
    local = x
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=x.shape, stride=contiguous_strides(x.shape))


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))

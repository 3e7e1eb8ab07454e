"""DTensor layout helpers for the port's models and FL round on a mesh.

DTensor (``torch.distributed.tensor``) partitions every op by its own
rules, which leave gaps that XLA's partitioner, the reference's, does not:
a matmul's batch folds a sharded dim only when it is the first of the
folded dims, a pending partial sum is reduced once, a contraction's result
may come back sharded on a dim that the next view cannot split, a
permute's gradient comes back strided.  Each helper here closes one such
gap where the models call it, by a redistribution (which adds the
collective a partitioner would have chosen) or a layout of the gradient.

Every such helper is the identity on a plain tensor (and returns the same
object), so the one-device paths run unchanged; none imports
``torch.distributed.tensor`` before a DTensor exists.  The attention's
own layout on a mesh (:func:`heads_layout`, :func:`attend_sequence_sharded`)
takes DTensors and runs its core on each rank's local tensors, so that
the collectives do not depend on DTensor's version.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["is_dtensor", "shard_ways", "settle", "split_ready", "merge_ready", "fold_ready",
           "gather_clients", "grad_as", "heads_layout", "local_of", "as_layout", "wrap_local",
           "write_at", "shard_range",
           "attend_sequence_sharded", "vocab_sharded", "pin_like", "distribute",
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


def wrap_local(local: torch.Tensor, like, placements, shape):
    """``local`` (this rank's shard) as the DTensor of global ``shape`` laid
    out by ``placements`` on ``like``'s mesh, contiguous strides."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, tuple(placements), run_check=False,
                              shape=tuple(shape), stride=contiguous_strides(shape))


def _local_as(x, placements):
    """A DTensor's local tensor once laid out by ``placements``; its
    gradient comes back in that layout (a pending sum's as replicated: each
    rank's part gets the whole gradient), made contiguous for DTensor's
    backward ops, which view it.  On a mesh of one device it keeps its
    strides, so that the mesh does the one device's arithmetic bitwise."""
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    if x.device_mesh.size() > 1:
        x = grad_as(x)
    return x.to_local(grad_placements=_settled(placements))


def local_of(x):
    """A DTensor's local tensor, its gradient coming back in its layout (see
    :func:`_local_as`); a plain tensor as it is."""
    return _local_as(x, x.placements) if is_dtensor(x) else x


def as_layout(local: torch.Tensor, like):
    """The local tensors ``local`` of each rank as one DTensor laid out as
    ``like`` (``like``'s global shape), contiguous: DTensor's
    decompositions view the local tensors they are given."""
    return wrap_local(local.contiguous(), like, like.placements, like.shape)


def heads_layout(q, k, v):
    """The attention's own layout on a mesh: ``q (B, T, H, hd)`` and ``k``,
    ``v (B, S, KV, hd)`` DTensors laid out alike, each rank holding its
    batch and its query heads (with their kv heads) whole over the
    sequence.  ``q`` keeps its batch and heads shardings (its other sharded
    dims are gathered, a pending sum reduced); ``k`` and ``v`` are laid out
    as ``q``.  Where ``q``'s heads are split over a mesh dim that does not
    split the kv heads (their ``KV`` do not divide it: they come as a
    pending sum, or replicated), ``k`` and ``v`` are first repeated to the
    ``H`` query heads on their local shards (``G = H / KV``; a pending sum
    and a kv-heads sharding repeat with them), so that a pending sum is
    reduce-scattered onto the query heads.  The attention core can then
    run on the local tensors, whatever DTensor's version would choose.
    Laid out already, they come back as they are."""
    from torch.distributed.tensor import Replicate

    G = q.shape[2] // k.shape[2]
    target = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in q.placements)
    if tuple(q.placements) != target:
        q = q.redistribute(q.device_mesh, target)
    out = [q]
    for t in (k, v):
        if G > 1 and any(a.is_shard(2) and not b.is_shard(2)
                         for a, b in zip(target, t.placements)):
            # the kv heads repeat in place: only the sequence and hd gathered
            pre = [p if p.is_partial() or p.is_shard(0) or p.is_shard(2) else Replicate()
                   for p in t.placements]
            local = _local_as(t, pre).repeat_interleave(G, dim=2)
            t = wrap_local(local, t, pre, (*t.shape[:2], q.shape[2], t.shape[3]))
        if tuple(t.placements) != target:
            t = t.redistribute(t.device_mesh, target)
        out.append(t)
    return tuple(out)


def shard_range(x, dim: int) -> Tuple[int, int]:
    """``(lo, size)``: the global indices ``[lo, lo + size)`` of ``dim``
    that this rank's shard of a DTensor holds (the whole dim for a plain
    tensor)."""
    lo, size = 0, x.shape[dim]
    if not is_dtensor(x):
        return lo, size
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            lo += coord[i] * size
    return lo, size


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
    lo, size = shard_range(x, dim)
    if lo <= index < lo + size:
        x.to_local().select(dim, index - lo).copy_(value)


def attend_sequence_sharded(q, k, v, scores):
    """Attention of ``q (B, T, H, hd)`` over a KV cache ``k``, ``v (B, S,
    KV, hd)`` whose sequence (dim 1) is sharded, without gathering the keys
    or the logits (the reference's reduction of the softmax): each rank
    scores its own slots, ``scores(q, k, lo) -> (B, KV, G, T, S_local)``
    f32 logits, masked, for the local ``q`` (every head), ``k`` and the
    global index ``lo`` of its first slot; the softmax's max and sum are
    all-reduced over the mesh dims that shard the sequence, and so is each
    rank's ``P V``.  Returns the f32 output, a DTensor with the batch laid
    out as the cache's and replicated over the other mesh dims."""
    from torch.distributed.tensor import Partial, Replicate

    batch = [p if p.is_shard(0) else Replicate() for p in k.placements]
    kv_pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in k.placements]
    seq = [p.is_shard(1) for p in kv_pl]
    ways = shard_ways(k, 0)

    def reduce(t, op):
        pending = [Partial(op) if s else p for s, p in zip(seq, batch)]
        whole = wrap_local(t, k, pending, (t.shape[0] * ways, *t.shape[1:]))
        return whole.redistribute(k.device_mesh, batch).to_local()

    ql = _local_as(q, batch)
    kl, vl = (_local_as(t, kv_pl) for t in (k, v))
    logits = scores(ql, kl, shard_range(k, 1)[0])
    m = reduce(logits.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(logits - m)
    w = p / reduce(p.sum(dim=-1, keepdim=True), "sum")
    out = reduce(torch.einsum("bkgts,bskh->btkgh", w, vl.float()).contiguous(), "sum")
    B, T, H, hd = q.shape
    return wrap_local(out.reshape(out.shape[0], T, H, hd), k, batch, (B, T, H, hd))


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
    rank's chunk of it, cut locally with no communication and moved to the
    mesh's device type (a checkpoint's CPU tensors restored onto a card's
    mesh move only their chunk).  A tensor dim sharded over several mesh
    dims is cut outer mesh dim first."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = sharding.placements()
    coord = mesh.get_coordinate()
    local = x
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    if local.device.type != mesh.device_type:
        local = local.to(mesh.device_type)
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=x.shape, stride=contiguous_strides(x.shape))


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))

"""Sharding rules: the specs of params, batches and caches per arch.

The counterpart of ``repro.launch.sharding``; the rules are the
reference's, carried over as they stand, since the port's param paths are
the reference's.  Every rule returns :class:`~repro_torch.dist.NamedSharding`
values (a spec on a mesh, with ``placements()`` and ``shard_shape()``) in
a tree of the input's structure, and reads the mesh only through its axis
names and sizes, so a duck-typed mesh will do.

Parameter rules are path-pattern based (Megatron-style tensor parallelism
over the ``model`` axis):

* embeddings / lm_head — vocab over ``model``;
* attention q/o projections — heads over ``model``;
* attention k/v projections — heads over ``model`` when the kv-head count
  divides the axis, else the d_model dim;
* MLP up/gate | down — d_ff over ``model`` (col | row);
* MoE experts — the expert axis over ``model`` when E divides it, else
  d_ff inside the experts;
* mamba / rwkv projections — the inner channel dim over ``model``;
* norms, scalars — replicated.

In ``per_client`` mode the params stay replicated over the client axes
(each client's copy exists only inside the round); with ``fsdp`` they are
also sharded over the client axes on their largest divisible free dim.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Tuple

from repro_torch import tree
from repro_torch.dist.constraints import NamedSharding, PartitionSpec
from repro_torch.dist.mesh import client_axes, mesh_view, n_clients
from repro_torch.models.common import ModelConfig

__all__ = ["param_shardings", "train_batch_shardings", "serve_batch_sharding",
           "cache_shardings", "replicated", "ShardingRule", "fl_round_rule", "telemetry_rule",
           "client_state_shardings", "channel_state_sharding"]

Params = Any


def _path_str(path: str) -> str:
    """A dotted tree path in the reference's ``a/b/c`` form."""
    return path.replace(".", "/")


def _axis_size(mesh, name: str) -> int:
    view = mesh_view(mesh)
    return view.shape[name] if name in view.axis_names else 1


def _divisible(dim: int, mesh, axis: str) -> bool:
    return dim % _axis_size(mesh, axis) == 0 and _axis_size(mesh, axis) > 1


def _caxis(ca: Tuple[str, ...]):
    return ca if len(ca) > 1 else ca[0]


def _map_with_path(fn, shapes: Params) -> Params:
    """``fn(path, leaf)`` over a tree (leaves: anything with ``.shape``)."""
    leaves, treedef = tree.flatten(shapes)
    return tree.unflatten(treedef, [fn(_path_str(p), leaf)
                                    for p, leaf in zip(tree.paths(shapes), leaves)])


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # pattern on the path suffix -> spec template applied to the LAST ndims
    # (None entries replicate; "model" shards over the model axis)
    (r"embed$", ("model", None)),
    (r"lm_head$", (None, "model")),
    (r"frontend_proj$|proj$", (None, "model")),
    # attention
    (r"attn.*/wq$|self/wq$|cross/wq$|mixers/l\d+/wq$", (None, "model", None)),
    (r"wk$|wv$", (None, "model", None)),  # checked for divisibility below
    (r"wo$", ("model", None, None)),
    # dense mlp
    (r"wg$|wu$", (None, "model")),
    (r"wd$", ("model", None)),
    # moe (3D expert-stacked; expert axis first)
    (r"router$", (None, None)),
    # mamba / rwkv projections
    (r"w_in$", (None, "model")),
    (r"w_out$", ("model", None)),
    (r"wr$", (None, "model")),
    (r"tm/wk$|tm/wv$|tm/wg$", (None, "model")),
    (r"cm/wk$", (None, "model")),
    (r"cm/wv$", ("model", None)),
    (r"tm/wo$", ("model", None)),
    (r"wa$", (None, None)),
    (r"wb$", (None, None)),
)


def _param_spec(path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh,
                fsdp_axes: Tuple[str, ...] = ()) -> PartitionSpec:
    ndim = len(shape)
    spec: list = [None] * ndim

    def fill_from_template(tmpl):
        # align the template to the trailing dims (leading dims are layer stacks)
        off = ndim - len(tmpl)
        for i, ax in enumerate(tmpl):
            if ax is not None and _divisible(shape[off + i], mesh, ax):
                spec[off + i] = ax

    # MoE expert tensors: (.., E, d, f) / (.., E, f, d)
    if re.search(r"ffns?.*/(wg|wu|wd)$", path) and ndim >= 3 and cfg.n_experts > 0:
        e_dim = ndim - 3
        if _divisible(shape[e_dim], mesh, "model"):
            spec[e_dim] = "model"  # expert parallelism
        else:
            # tensor parallelism inside the experts: shard the f dim
            f_dim = ndim - 2 if path.endswith("wd") else ndim - 1
            if _divisible(shape[f_dim], mesh, "model"):
                spec[f_dim] = "model"
        return _with_fsdp(path, spec, shape, mesh, fsdp_axes)

    # kv projections with few heads: fall back to sharding d_model
    if re.search(r"wk$|wv$", path) and ndim >= 3:
        off = ndim - 3
        if _divisible(shape[off + 1], mesh, "model"):
            spec[off + 1] = "model"
        elif _divisible(shape[off], mesh, "model"):
            spec[off] = "model"
        return _with_fsdp(path, spec, shape, mesh, fsdp_axes)

    for pat, tmpl in _RULES:
        if re.search(pat, path) and ndim >= len(tmpl):
            fill_from_template(tmpl)
            break
    return _with_fsdp(path, spec, shape, mesh, fsdp_axes)


def _with_fsdp(path, spec, shape, mesh, fsdp_axes) -> PartitionSpec:
    """fsdp: also shard the largest free dim over the client axes
    (ZeRO-3-style fully sharded storage)."""
    if fsdp_axes:
        n = math.prod(_axis_size(mesh, a) for a in fsdp_axes)
        if n > 1:
            free = [i for i, s in enumerate(spec) if s is None]
            free.sort(key=lambda i: -shape[i])  # the largest divisible free dim first
            for i in free:
                if shape[i] % n == 0:
                    spec[i] = _caxis(fsdp_axes)
                    break
    return PartitionSpec(*spec)


def param_shardings(cfg: ModelConfig, params_shape: Params, mesh, *,
                    fsdp: bool = False) -> Params:
    """The shardings of a params tree (meta tensors will do)."""
    fsdp_axes = client_axes(mesh) if fsdp else ()
    return _map_with_path(
        lambda p, leaf: NamedSharding(mesh, _param_spec(p, tuple(leaf.shape), cfg, mesh,
                                                        fsdp_axes)),
        params_shape)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def train_batch_shardings(mesh, mode: str, batch_shape: Params, *, scan: bool = False) -> Params:
    """Train batches.  per_client / weighted_grad: the leading client dim
    over the client axes; client_sequential: the per-step batch dim (axis
    2); weighted_flat: the flat batch over the whole mesh when it divides.
    ``scan=True``: a leading K-round axis, unsharded, shifts the rules
    right by one."""
    ca = client_axes(mesh)
    caxis = _caxis(ca)
    off = 1 if scan else 0
    view = mesh_view(mesh)

    def f(path, leaf):
        ndim = len(leaf.shape)
        spec = [None] * ndim
        if mode == "weighted_flat":
            full = (*ca, "model")
            n_full = math.prod(view.shape[a] for a in full)
            spec[off] = full if leaf.shape[off] % n_full == 0 else caxis
        elif mode in ("per_client", "weighted_grad"):
            spec[off] = caxis
        elif ndim >= off + 3:  # client_sequential: shard the per-step batch dim
            spec[off + 2] = caxis
        return NamedSharding(mesh, PartitionSpec(*spec))

    return _map_with_path(f, batch_shape)


def serve_batch_sharding(mesh, shape: Tuple[int, ...]) -> NamedSharding:
    """A serving batch (B, ...): the batch over the client axes when it divides."""
    spec = [None] * len(shape)
    if shape[0] % n_clients(mesh) == 0 and shape[0] > 1:
        spec[0] = _caxis(client_axes(mesh))
    return NamedSharding(mesh, PartitionSpec(*spec))


def cache_shardings(cfg: ModelConfig, mesh, cache_shape: Params) -> Params:
    """KV caches (L, B, S, KV, hd) / recurrent states (L, B, H, ...): the
    batch over the client axes when it divides; heads over ``model`` when
    they divide, else the sequence over ``model`` (a sequence-parallel
    cache)."""
    caxis = _caxis(client_axes(mesh))
    nc = n_clients(mesh)

    def f(p, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = [None] * ndim
        if ndim >= 2 and shape[1] % nc == 0 and shape[1] > 1:
            spec[1] = caxis  # batch dim
        if re.search(r"(^|/)(k|v)$", p) and ndim >= 5:
            if _divisible(shape[3], mesh, "model"):
                spec[3] = "model"  # kv heads
            elif _divisible(shape[2], mesh, "model"):
                spec[2] = "model"  # sequence-parallel cache
        elif re.search(r"ssm$|wkv$", p) and ndim >= 3:
            if _divisible(shape[2], mesh, "model"):
                spec[2] = "model"  # recurrent-state heads
        elif re.search(r"memory$", p) and ndim == 3:
            if _divisible(shape[2], mesh, "model"):
                spec[2] = "model"
        return NamedSharding(mesh, PartitionSpec(*spec))

    return _map_with_path(f, cache_shape)


def replicated(mesh, tree_: Params) -> Params:
    return tree.map(lambda _: NamedSharding(mesh, PartitionSpec()), tree_)


# ---------------------------------------------------------------------------
# client-axis rules (FL round operands)
# ---------------------------------------------------------------------------

_CLIENTS = "clients"


@dataclasses.dataclass(frozen=True)
class ShardingRule:
    """A declarative sharding rule.

    Ordered ``(path-pattern, templates)`` pairs: the first pattern that
    matches a leaf's path selects its templates, and the first template
    whose length equals the leaf's ndim (after ``skip_leading`` scan dims)
    is applied dim by dim.  The placeholder ``"clients"`` resolves to the
    mesh's client axes (``pod``/``data``); any other entry names a mesh
    axis.  An axis that does not divide its dim is dropped.
    """

    rules: Tuple[Tuple[str, Tuple[Tuple[Optional[str], ...], ...]], ...]
    # leading dims excluded from matching (the chunked engine's K-round axis)
    skip_leading: int = 0

    def spec(self, path: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
        dims = tuple(shape[self.skip_leading:])
        spec: list = [None] * len(shape)
        for pat, templates in self.rules:
            if not re.search(pat, path):
                continue
            for tmpl in templates:
                if len(tmpl) != len(dims):
                    continue
                for i, ax in enumerate(tmpl):
                    if ax is None:
                        continue
                    axes = client_axes(mesh) if ax == _CLIENTS else (ax,)
                    size = math.prod(_axis_size(mesh, a) for a in axes)
                    if size > 1 and dims[i] % size == 0:
                        spec[self.skip_leading + i] = _caxis(axes)
                break
            break
        return PartitionSpec(*spec)

    def shardings(self, mesh, tree_: Params) -> Params:
        """The shardings of a (shape) tree, one leaf at a time."""
        return _map_with_path(
            lambda p, leaf: NamedSharding(mesh, self.spec(p, tuple(leaf.shape), mesh)), tree_)


def fl_round_rule(*, scan: bool = False) -> ShardingRule:
    """The FL round's connectivity operands, along the client axes:
    ``tau_up (n,)`` its client dim; dense ``tau_dd`` / ``A (n, n)`` their
    rows; block ``(C, m, m)`` tensors the cluster axis.  ``scan=True``
    skips the leading K-round axis."""
    return ShardingRule(
        rules=(
            (r"(^|/)tau_up$", ((_CLIENTS,),)),
            (r"(^|/)(tau_dd|tau_b|A|Ab)$", ((_CLIENTS, None), (_CLIENTS, None, None))),
        ),
        skip_leading=1 if scan else 0,
    )


def telemetry_rule(*, scan: bool = False) -> ShardingRule:
    """The instrumented round's operands: the ``(n,)`` outage-streak carry
    and the per-client metric vectors along the client axes; the
    ``weight_drift`` scalar replicates.  ``scan=True`` skips the leading
    K-round axis of the stacked ``(K, n)`` metric outputs."""
    return ShardingRule(
        rules=(
            (r"(^|/)(client_participation|client_uplink_bits"
             r"|outage_streak|streak)$", ((_CLIENTS,),)),
        ),
        skip_leading=1 if scan else 0,
    )


def client_state_shardings(mesh, tree_: Params, n_fl_clients: int) -> Params:
    """A strategy's carried state: any leaf whose leading axis is the client
    population shards it over the client axes (the memory strategy's
    ``(n, d)`` buffer, the async carry's age vector and staging buffer);
    other leaves (scalars, codec state) replicate."""
    ca = client_axes(mesh)
    nc = math.prod(_axis_size(mesh, a) for a in ca)

    def f(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec: list = [None] * len(shape)
        if len(shape) >= 1 and shape[0] == n_fl_clients and nc > 1 and n_fl_clients % nc == 0:
            spec[0] = _caxis(ca)
        return NamedSharding(mesh, PartitionSpec(*spec))

    return tree.map(f, tree_)


def channel_state_sharding(mesh, shape: Tuple[int, ...]) -> NamedSharding:
    """The in-scan channel sampler's packed per-link gate vector: over the
    client axes when its length divides, else replicated."""
    ca = client_axes(mesh)
    nc = math.prod(_axis_size(mesh, a) for a in ca)
    spec: list = [None] * len(shape)
    if len(shape) >= 1 and nc > 1 and shape[0] % nc == 0:
        spec[0] = _caxis(ca)
    return NamedSharding(mesh, PartitionSpec(*spec))

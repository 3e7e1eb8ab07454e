"""The port's sharding rules (``repro_torch.dist``, ``repro_torch.launch.
{mesh,sharding,steps}``) against the reference's, spec for spec.

The meshes are duck-typed, as ``tests/test_clustered.py`` has them for the
reference: the port's rules read only a mesh's axis names and sizes, and
the reference's take a ``jax.sharding.AbstractMesh`` of the same shape, so
no process group and no device is needed.  Every arch id is compared at
its ``full()`` shapes: meta tensors on the port's side, ``jax.eval_shape``
on the reference's.
"""

import functools
import math
import types

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import base as jbase
from repro.dist import constraints as jconstraints
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.dist import constraints, layout, mesh as tmesh
from repro_torch.dist import NamedSharding, PartitionSpec, constrain, constrain_act, use_mesh
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import sharding, specs, steps

ARCHS = sorted(base.CLI_ALIASES)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
MODES = ("per_client", "client_sequential", "weighted_grad", "weighted_flat")


def _meshes(name):
    """(the port's duck-typed mesh, the reference's abstract mesh)."""
    shape, names = MESHES[name]
    duck = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    return duck, AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _param_specs(arch):
    return (specs.params_spec(steps.build(base.get_arch(arch).full())),
            jspecs.params_spec(jspecs.build(jbase.get_arch(arch).full())))


@functools.lru_cache(maxsize=None)
def _input_specs(arch, shape_name, mesh_name):
    duck, amesh = _meshes(mesh_name)
    return specs.input_specs(arch, shape_name, duck), jspecs.input_specs(arch, shape_name, amesh)


def _jpath(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _same(got, want):
    """A tree of the port's shardings against one of the reference's: the
    same paths, each with the same spec."""
    jl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, (jax.sharding.NamedSharding, P)))[0]
    assert tree.paths(got) == [_jpath(p) for p, _ in jl]
    for path, g, (_, w) in zip(tree.paths(got), tree.leaves(got), jl):
        wspec = w.spec if isinstance(w, jax.sharding.NamedSharding) else w
        gspec = g.spec if isinstance(g, NamedSharding) else g
        assert tuple(gspec) == tuple(wspec), (path, gspec, wspec)


# -- meshes -----------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_client_axes_and_counts_equal_the_reference(mesh_name):
    duck, amesh = _meshes(mesh_name)
    for mod in (tmesh, lmesh):
        assert mod.client_axes(duck) == jmesh.client_axes(amesh)
        assert mod.n_clients(duck) == jmesh.n_clients(amesh)
        assert mod.client_axis_spec(duck) == jmesh.client_axis_spec(amesh)
    view = tmesh.mesh_view(duck)
    assert view.shape == duck.shape and tmesh.mesh_view(view) is view


# -- params ------------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh_name, fsdp):
    duck, amesh = _meshes(mesh_name)
    got_p, want_p = _param_specs(arch)
    got = sharding.param_shardings(base.get_arch(arch).full(), got_p, duck, fsdp=fsdp)
    want = jsharding.param_shardings(jbase.get_arch(arch).full(), want_p, amesh, fsdp=fsdp)
    _same(got, want)
    # the bytes one device holds
    got_bytes = sum(math.prod(s.shard_shape(tuple(p.shape))) * p.element_size()
                    for s, p in zip(tree.leaves(got), tree.leaves(got_p)))
    want_bytes = sum(math.prod(s.shard_shape(p.shape)) * p.dtype.itemsize for s, p in zip(
        jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)),
        jax.tree.leaves(want_p)))
    assert got_bytes == want_bytes > 0


# -- batches and caches -------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_match_reference(arch, mesh_name):
    duck, amesh = _meshes(mesh_name)
    cfg, jcfg = base.get_arch(arch).full(), jbase.get_arch(arch).full()
    C = tmesh.n_clients(duck)
    shape = base.INPUT_SHAPES["train_4k"]
    for mode in MODES:
        got_b = specs._train_batch_spec(cfg, C, shape, mode)
        want_b = jspecs._train_batch_spec(jcfg, C, jbase.INPUT_SHAPES["train_4k"], mode)
        for scan in (False, True):
            _same(sharding.train_batch_shardings(duck, mode, got_b, scan=scan),
                  jsharding.train_batch_shardings(amesh, mode, want_b, scan=scan))
    for shape_name in base.supported_shapes(arch):
        kind = base.INPUT_SHAPES[shape_name].kind
        if kind == "train":
            continue
        got, want = _input_specs(arch, shape_name, mesh_name)
        if kind == "prefill":
            for k in got["batch"]:
                s = tuple(got["batch"][k].shape)
                assert tuple(sharding.serve_batch_sharding(duck, s).spec) == \
                    tuple(jsharding.serve_batch_sharding(amesh, s).spec)
            continue
        _same(sharding.cache_shardings(cfg, duck, got["cache"]),
              jsharding.cache_shardings(jcfg, amesh, want["cache"]))
        s = tuple(got["token"].shape)
        assert tuple(sharding.serve_batch_sharding(duck, s).spec) == \
            tuple(jsharding.serve_batch_sharding(amesh, s).spec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_replicated_is_the_empty_spec(mesh_name):
    duck, amesh = _meshes(mesh_name)
    got = sharding.replicated(duck, {"a": 1, "b": [2, 3]})
    want = jsharding.replicated(amesh, {"a": 1, "b": [2, 3]})
    _same(got, want)


# -- client-axis rules ----------------------------------------------------------------------

_RULE_CASES = [("tau_up", (16,)), ("tau_up", (32,)), ("tau_up", (6,)), ("tau_dd", (16, 16)),
               ("tau_dd", (32, 32)), ("A", (16, 16)), ("A", (8, 4, 4)), ("A", (3, 4, 4)),
               ("Ab", (32, 4, 4)), ("tau_b", (16, 2, 2)), ("other", (16,)),
               ("streak", (16,)), ("client_participation", (32,)), ("outage_streak", (6,)),
               ("client_uplink_bits", (16,)), ("weight_drift", ())]


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("rule", ["fl_round_rule", "telemetry_rule"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_client_axis_rules_match_reference(mesh_name, rule, scan):
    duck, amesh = _meshes(mesh_name)
    r, jr = getattr(sharding, rule)(scan=scan), getattr(jsharding, rule)(scan=scan)
    for path, shape in _RULE_CASES:
        shape = ((5,) + shape) if scan else shape
        assert tuple(r.spec(path, shape, duck)) == tuple(jr.spec(path, shape, amesh)), \
            (path, shape)
    leaves = {p: np.zeros(s) for p, s in _RULE_CASES[:6]}
    if scan:
        leaves = {p: np.zeros((5,) + v.shape) for p, v in leaves.items()}
    _same(r.shardings(duck, leaves), jr.shardings(amesh, leaves))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_client_state_and_channel_state_shardings_match_reference(mesh_name):
    duck, amesh = _meshes(mesh_name)
    for n in (16, 32, 6):
        state = {"buf": np.zeros((n, 100)), "age": np.zeros((n,)), "scalar": np.zeros(()),
                 "other": np.zeros((7, n))}
        _same(sharding.client_state_shardings(duck, state, n),
              jsharding.client_state_shardings(amesh, state, n))
    for shape in [(16,), (32,), (48, 3), (6,), (136,)]:
        assert tuple(sharding.channel_state_sharding(duck, shape).spec) == \
            tuple(jsharding.channel_state_sharding(amesh, shape).spec)


# -- spec fitting and placements --------------------------------------------------------------

_FIT_SPECS = [(None, "model", None), ("model", None, None), (("pod", "data"), None, None),
              ("data", "model"), (("data", "model"), None, None), ("model",), (None, None),
              ("pod", "model", None, None), ("nope", "model")]
_FIT_SHAPES = [(8, 32, 64), (4, 2, 16), (16, 4096, 1024), (2, 3), (32,), (6, 16, 5),
               (64, 64, 64, 64)]


@pytest.mark.parametrize("shape", _FIT_SHAPES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fit_spec_matches_reference(mesh_name, shape):
    duck, amesh = _meshes(mesh_name)
    for spec in _FIT_SPECS:
        got = constraints._fit_spec(spec, shape, duck)
        want = jconstraints._fit_spec(spec, shape, amesh)
        assert (got is None) == (want is None), (spec, got, want)
        if got is not None:
            assert tuple(got) == tuple(want), (spec, got, want)


def test_spec_placements_and_shard_shape():
    from torch.distributed.tensor import Replicate, Shard

    duck, amesh = _meshes("2x16x16")
    spec = PartitionSpec(("pod", "data"), None, "model")
    assert spec.placements(duck) == (Shard(0), Shard(0), Shard(2))
    assert PartitionSpec(None, "data").placements(duck) == (Replicate(), Shard(1), Replicate())
    assert PartitionSpec().placements(duck) == (Replicate(),) * 3
    sh = NamedSharding(duck, spec)
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2) == \
        jax.sharding.NamedSharding(amesh, P(("pod", "data"), None, "model")).shard_shape(
            (64, 3, 32))
    assert sh.placements() == spec.placements(duck)


def test_hooks_are_the_identity_outside_a_mesh_and_on_plain_tensors():
    import torch

    x = torch.ones(2, 8, 4)
    cfg = base.get_arch("qwen3-0.6b").smoke().replace(act_spec=(None, "model", None))
    assert constrain(x, ("data", "model", None)) is x and constrain_act(cfg, x) is x
    assert constraints.constrain_grads({"a": x}, None)["a"] is x
    assert layout.settle(x) is x and layout.pin_like(x, x) is x
    assert layout.merge_ready(x) is x and layout.fold_ready(x, (0, 2)) is x
    assert layout.gather_clients(x) is x and layout.grad_as(x, x) is x
    duck, _ = _meshes("4x2")
    with use_mesh(duck):
        assert constraints.current_mesh() is duck
        assert constrain(x, ("data", "model", None)) is x  # a plain tensor
        with use_mesh(None):
            assert constraints.current_mesh() is None
    assert constraints.current_mesh() is None
    for spmd in (None, (), ("data",), ("pod", "data")):
        assert constraints.spmd_axis_name(spmd) == jconstraints.spmd_axis_name(spmd)


# -- the step builder over a mesh ---------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape_name", [("qwen3-0.6b", "train_4k"),
                                             ("qwen3-0.6b", "prefill_32k"),
                                             ("qwen3-0.6b", "decode_32k"),
                                             ("granite-moe-3b-a800m", "train_4k"),
                                             ("granite-moe-3b-a800m", "prefill_32k"),
                                             ("jamba-1.5-large-398b", "train_4k")])
def test_build_step_shardings_and_configs_match_reference(arch, shape_name, mesh_name):
    duck, amesh = _meshes(mesh_name)
    step, args, in_sh, out_sh = steps.build_step(arch, shape_name, duck)
    jstep, jargs, jin_sh, jout_sh = jsteps.build_step(arch, shape_name, amesh)
    _same(list(in_sh), list(jin_sh))
    _same(list(out_sh) if isinstance(out_sh, tuple) else [out_sh],
          list(jout_sh) if isinstance(jout_sh, tuple) else [jout_sh])
    assert len(args) == len(jargs)
    for a, ja in zip(args, jargs):
        assert [tuple(x.shape) for x in tree.leaves(a) if hasattr(x, "shape")] == \
            [tuple(x.shape) for x in jax.tree.leaves(ja)]
    if base.INPUT_SHAPES[shape_name].kind == "train":
        assert step.donate_argnums == jstep.donate_argnums
        rs = steps.train_state_shardings(arch, shape_name, duck)
        jrs = jsteps.train_state_shardings(arch, shape_name, amesh)
        assert sorted(rs) == sorted(jrs)
        for k in rs:
            _same(rs[k], jrs[k])


def test_build_step_without_a_mesh_is_the_one_device_step():
    step, args, in_sh, out_sh = steps.build_step("qwen3-0.6b", "decode_32k", None)
    assert in_sh is None and out_sh is None and callable(step) and len(args) == 4
    step, args, _, _ = steps.build_step("qwen3-0.6b", "train_4k", None, n_clients=8)
    assert args[3]["tokens"].shape[0] == 8 and step.donate_argnums == (0, 1, 2)
    # the chunked engine builds on a mesh too: its K-leading args
    step, args, in_sh, _ = steps.build_step("qwen3-0.6b", "train_4k", _meshes("4x2")[0],
                                            scan_rounds=2)
    assert args[3]["tokens"].shape[:2] == (2, 4) and args[4].shape == (2, 4)
    assert step.metric_keys == ("loss", "delta_norm", "participation", "uplink_bits",
                                "weight_sum") and step.donate_argnums == (0, 1, 2)
    assert tuple(in_sh[4].spec) == (None, "data")

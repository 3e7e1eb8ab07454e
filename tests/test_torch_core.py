"""The port's core, data, channel and strategy layers against the reference.

Inputs come from numpy with a seed and go to both packages.  Host-side
numpy copies (COPT-alpha, channel draws, data) must agree exactly; the
aggregation paths run f32 arithmetic in another order than XLA and are
held at atol 1e-5; within the port, segmented == monolithic is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.channel.base import StaticChannel as JStaticChannel
from repro.configs import colrel_paper as jcolrel_paper
from repro.core import flatten as jflatten
from repro.core import relay as jrelay
from repro.core import topology as jtopology
from repro.core.weights import optimize_weights as joptimize_weights
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import build as jbuild
from repro.strategies.base import ExecutionContext as JExecutionContext
from repro_torch import strategies, tree
from repro_torch.channel.base import StaticChannel
from repro_torch.configs import colrel_paper
from repro_torch.convert import params_from_jax
from repro_torch.core import flatten, relay, topology
from repro_torch.core.weights import optimize_weights
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.models.cnn import CNN
from repro_torch.strategies.base import ExecutionContext

ATOL = 1e-5


def _jax_param_shapes(cfg):
    """The reference CNN's parameter tree as shapes (no init computed)."""
    return jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))


def _jax_paths(params):
    def name(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))

    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return [".".join(name(k) for k in path) for path, _ in flat]


@pytest.mark.parametrize("setup,n_leaves,d", [(colrel_paper.full, 61, 272282),
                                              (colrel_paper.reduced, 25, 19858)])
def test_cnn_leaf_order_and_flat_spec_match_reference(setup, n_leaves, d):
    jparams = _jax_param_shapes(getattr(jcolrel_paper, setup.__name__)().cnn)
    params = CNN(setup().cnn, generator=torch.Generator().manual_seed(0)).param_tree()
    assert tree.paths(params) == _jax_paths(jparams)
    jspec = jflatten.flat_spec(jparams)
    spec = flatten.flat_spec(params)
    assert len(spec.shapes) == n_leaves and spec.d == d
    assert spec.shapes == jspec.shapes
    assert spec.sizes == jspec.sizes and spec.offsets == jspec.offsets


def test_tree_sorts_dict_keys_like_jax():
    t = {"stem": 1, "fc": {"w": 2, "b": 3}, "b": [4, (5, 6)]}
    leaves, td = tree.flatten(t)
    assert leaves == jax.tree.leaves(t) == [4, 5, 6, 3, 2, 1]
    assert tree.unflatten(td, leaves) == t
    assert tree.paths(t) == ["b.0", "b.1.0", "b.1.1", "fc.b", "fc.w", "stem"]
    assert tree.from_paths(dict(zip(tree.paths({"a": [7, 8]}), [7, 8]))) == {"a": [7, 8]}


def _stacked_tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 7)).astype(np.float32),
            "blocks": [{"k": rng.normal(size=(n, 2, 2, 3)).astype(np.float32)},
                       {"k": rng.normal(size=(n, 1)).astype(np.float32)}]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ravel_unravel_roundtrip_and_layout(dtype):
    npt = _stacked_tree(4, seed=0)
    t = tree.map(torch.from_numpy, npt)
    spec = flatten.flat_spec(t, stacked=True)
    stack = flatten.ravel_stacked(t, dtype=dtype)
    assert stack.shape == (4, spec.d) and stack.dtype == dtype
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jstack = jflatten.ravel_stacked(jax.tree.map(jnp.asarray, npt), dtype=jdtype)
    np.testing.assert_array_equal(stack.float().numpy(),
                                  np.asarray(jstack.astype(jnp.float32)))
    back = flatten.unravel_stacked(spec, stack, dtype=torch.float32)
    want = tree.map(lambda x: x.to(dtype).float(), t)
    for a, b in zip(tree.leaves(back), tree.leaves(want)):
        assert torch.equal(a, b)
    segs = flatten.ravel_stacked_segments(t, dtype=dtype)
    assert torch.equal(torch.cat(segs, dim=1), stack)
    flat = stack[0].float()
    for a, b in zip(tree.leaves(flatten.unravel(spec, flat)), tree.leaves(back)):
        assert torch.equal(a, b[0])


def _round(n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) * 0.5 + 0.1).astype(np.float32)
    tau_up = (rng.random(n) < 0.7).astype(np.float32)
    tau_dd = (rng.random((n, n)) < 0.5).astype(np.float32)
    np.fill_diagonal(tau_dd, 1.0)
    return A, tau_up, tau_dd


@pytest.mark.parametrize("fused", [False, True])
def test_colrel_round_delta_matches_reference(fused):
    A, tau_up, tau_dd = _round(10, seed=1)
    X = np.random.default_rng(2).normal(size=(10, 777)).astype(np.float32)
    want = jrelay.colrel_round_delta(jnp.asarray(X), jnp.asarray(A), jnp.asarray(tau_up),
                                     jnp.asarray(tau_dd), fused=fused)
    got = relay.colrel_round_delta(torch.from_numpy(X), torch.from_numpy(A),
                                   torch.from_numpy(tau_up), torch.from_numpy(tau_dd),
                                   fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,options", [
    ("colrel", {"fused": False}), ("colrel", {"fused": "collapse"}),
    ("colrel", {"fused": "kernel"}), ("fedavg_perfect", {}),
    ("fedavg_blind", {}), ("fedavg_nonblind", {}),
])
def test_strategy_aggregate_tree_matches_reference(name, options):
    n = 10
    A, tau_up, tau_dd = _round(n, seed=3)
    npt = _stacked_tree(n, seed=4)
    jt = [jnp.asarray(a) for a in (tau_up, tau_dd, A)]
    tt = [torch.from_numpy(a) for a in (tau_up, tau_dd, A)]
    want, _ = jstrategies.get(name, **options).aggregate_tree(
        jax.tree.map(jnp.asarray, npt), *jt, (), JExecutionContext(n_clients=n))
    got, _ = strategies.get(name, **options).aggregate_tree(
        tree.map(torch.from_numpy, npt), *tt, (), ExecutionContext(n_clients=n))
    assert tree.paths(got) == _jax_paths(want)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    ws = strategies.get(name, **options).weights(*tt)
    np.testing.assert_allclose(ws.numpy(), np.asarray(jstrategies.get(name, **options)
                                                      .weights(*jt)), atol=1e-6, rtol=0)


def test_colrel_kernel_segments_equal_monolithic_bitwise():
    n = 10
    A, tau_up, tau_dd = _round(n, seed=5)
    t = tree.map(torch.from_numpy, _stacked_tree(n, seed=6))
    args = [torch.from_numpy(a) for a in (tau_up, tau_dd, A)]
    s = strategies.get("colrel", fused="kernel")
    mono, _ = s.aggregate_tree(t, *args, (), ExecutionContext(n_clients=n))
    seg, _ = s.aggregate_tree(t, *args, (), ExecutionContext(n_clients=n, segment_d=1))
    for a, b in zip(tree.leaves(mono), tree.leaves(seg)):
        assert torch.equal(a, b)


def test_unported_strategies_raise():
    for name in ("multihop", "clustered", "async_colrel"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            strategies.get(name)
    assert {"memory", "quantized"} <= set(strategies.available())


def test_copt_alpha_on_fig2b_equals_reference():
    got = optimize_weights(topology.paper_fig2b(), sweeps=30, fine_tune_sweeps=30)
    want = joptimize_weights(jtopology.paper_fig2b(), sweeps=30, fine_tune_sweeps=30)
    np.testing.assert_array_equal(got.A, want.A)
    assert got.S == want.S and got.converged == want.converged


def test_static_channel_taus_equal_reference():
    model = topology.paper_fig2b()
    ch, jch = StaticChannel(model, seed=3, block=8), JStaticChannel(jtopology.paper_fig2b(),
                                                                     seed=3, block=8)
    for r in range(20):
        for a, b in zip(ch.tau_for_round(r), jch.tau_for_round(r)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ch.trace(20, 13), jch.trace(20, 13)):
        np.testing.assert_array_equal(a, b)


def test_data_and_batches_equal_reference():
    images, labels = synthetic.synthetic_cifar(n=200, seed=1)
    jimages, jlabels = jsynthetic.synthetic_cifar(n=200, seed=1)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(labels, jlabels)
    for mk, jmk in ((lambda p: p.partition_iid(200, 10, seed=0),) * 2,
                    (lambda p: p.partition_sort_and_partition(labels, 10, s=3, seed=0),) * 2):
        for a, b in zip(mk(partition), jmk(jpartition)):
            np.testing.assert_array_equal(a, b)
    parts = partition.partition_iid(200, 10, seed=0)
    arrays = {"images": images, "labels": labels}
    clients = pipeline.make_federated_clients(arrays, parts, 4, seed=0)
    jclients = jpipeline.make_federated_clients(arrays, parts, 4, seed=0)
    for _ in range(2):
        got = pipeline.stack_chunk_batches(clients, 3, 1)
        want = jpipeline.stack_chunk_batches(jclients, 3, 1)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    q, jq = synthetic.quadratic_problem(10, 16, seed=0), jsynthetic.quadratic_problem(10, 16, seed=0)
    for k in ("H", "centers", "x_star"):
        np.testing.assert_array_equal(q[k], jq[k])


def test_params_from_jax_keeps_tree_and_values():
    shapes = _jax_param_shapes(jcolrel_paper.reduced().cnn)
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    params = params_from_jax(np_params, "cpu")
    assert tree.paths(params) == _jax_paths(shapes)
    for a, b in zip(tree.leaves(params), jax.tree.leaves(np_params)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)

"""The port's clustered (block-sparse) relaying against the reference.

Three layers:

1. the block substrate: ``clustered_blocks`` and its dense round trip,
   and per-cluster COPT-alpha against the reference's
   ``optimize_weights_clustered`` (the numpy solver is copied, so 1e-10);
2. every execution of the port's ``clustered`` strategy (``fused`` in
   {False, "collapse", "kernel"}, ``segment_d`` in {0, 1}) against a live
   two-round run of the reference's ``clustered`` strategy with
   ``fused=False``, through ``FLTrainer`` with a clustered channel and
   ``(C, m, m)`` weights, on two problems: a 15-client quadratic with
   distinct random blocks (C=3, m=5) and the reduced CIFAR CNN at n=10
   (C=2, m=5).  Both packages get the same numpy taus in block form (the
   reference's ``ClusteredStaticChannel`` trace, served by a fixed-trace
   channel), the same task built from the same spec and seed, the same
   ``Ab`` and the reference's init params through ``params_from_jax``.
   Tolerances are ``tests/test_torch_slice.py``'s: counts equal,
   ``weight_sum`` 1e-6, losses rtol 1e-5, params atol 1e-6;
3. C = 1 clustered against the port's own ``colrel``: the kernel and
   segment paths run the same plain arithmetic in the same order and are
   held bitwise; the collapse and faithful paths contract through
   ``einsum``/``bmm`` where ``colrel`` uses ``tensordot``, so they are held
   at 1e-6 (params) and 1e-6 (``weight_sum``), the latter for every path.
"""

import jax
import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.channel import ClusteredStaticChannel as JClusteredStaticChannel
from repro.core import blocks as jblocks
from repro.core import topology as jtopology
from repro.core.connectivity import reciprocity_matrix
from repro.core.weights import optimize_weights_clustered as joptimize_weights_clustered
from repro.fl import FLTrainer as JFLTrainer
from repro.fl import experiment as jexperiment
from repro_torch import strategies, tree
from repro_torch.channel import StaticChannel
from repro_torch.convert import params_from_jax
from repro_torch.core import blocks, topology
from repro_torch.core.weights import (
    is_unbiased_clustered,
    optimize_weights,
    optimize_weights_clustered,
    unbiasedness_residual_clustered,
)
from repro_torch.fl.experiment import ExperimentSpec, build_experiment, build_task
from repro_torch.fl.trainer import FLTrainer

ROUNDS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Tiny CPU convolutions run fastest and most repeatably on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_blocks(C=3, m=5, seed=0, rho=0.6):
    """(p, Pb, Eb) of a clustered model with distinct random blocks, as
    ``tests/test_clustered.py`` builds them."""
    rng = np.random.default_rng(seed)
    Pb = rng.uniform(0.4, 0.95, size=(C, m, m))
    for c in range(C):
        np.fill_diagonal(Pb[c], 1.0)
    Eb = np.stack([reciprocity_matrix(Pb[c], rho) for c in range(C)])
    p = rng.uniform(0.3, 0.9, size=C * m)
    return p, Pb, Eb


# ---------------------------------------------------------------------------
# 1. the block substrate
# ---------------------------------------------------------------------------


def test_clustered_blocks_equal_the_reference_and_round_trip():
    model = topology.clustered_blocks(24, 0.5, 6, p_intra=0.8, rho=0.7)
    want = jtopology.clustered_blocks(24, 0.5, 6, p_intra=0.8, rho=0.7)
    for field in ("p", "Pb", "Eb"):
        np.testing.assert_array_equal(getattr(model, field), getattr(want, field))
    dense = model.to_dense()
    flat = topology.clustered(24, 0.5, 6, p_intra=0.8, p_inter=0.0, rho=0.7)
    np.testing.assert_array_equal(dense.P, flat.P)
    np.testing.assert_array_equal(dense.E, flat.E)
    back = blocks.ClusteredLinkModel.from_dense(dense, 6)
    np.testing.assert_array_equal(back.Pb, model.Pb)
    np.testing.assert_array_equal(back.Eb, model.Eb)
    bad = dense.P.copy()
    bad[0, 7] = 0.5
    with pytest.raises(ValueError, match="outside the diagonal blocks"):
        blocks.blocks_from_dense(bad, blocks.ClusterSpec(24, 6), strict=True)
    with pytest.raises(ValueError, match="must divide"):
        blocks.ClusterSpec(10, 3)


def test_block_copt_matches_the_reference_and_the_dense_solver():
    p, Pb, Eb = _random_blocks(seed=2)
    model = blocks.ClusteredLinkModel(p, Pb, Eb)
    res = optimize_weights_clustered(model, sweeps=30, fine_tune_sweeps=10)
    want = joptimize_weights_clustered(jblocks.ClusteredLinkModel(p, Pb, Eb),
                                       sweeps=30, fine_tune_sweeps=10)
    np.testing.assert_allclose(res.Ab, want.Ab, rtol=0, atol=1e-10)
    np.testing.assert_allclose([res.S, res.Sbar, res.S_init], [want.S, want.Sbar, want.S_init],
                               rtol=1e-10)
    assert res.converged == want.converged
    # the decomposition is exact: the dense solver gives the same blocks
    dense = optimize_weights(model.to_dense(), sweeps=30, fine_tune_sweeps=10)
    np.testing.assert_allclose(
        res.Ab, blocks.blocks_from_dense(dense.A, model.spec, strict=False), atol=1e-9)
    assert is_unbiased_clustered(model, res.Ab)
    assert np.max(np.abs(unbiasedness_residual_clustered(model, res.Ab))) < 1e-8


def test_block_ops_match_the_reference():
    rng = np.random.default_rng(4)
    C, m, d = 3, 5, 37
    Ab = rng.uniform(0.1, 2.0, size=(C, m, m)).astype(np.float32)
    tau_b = rng.integers(0, 2, size=(C, m, m)).astype(np.float32)
    tau_up = rng.integers(0, 2, size=(C * m,)).astype(np.float32)
    X = rng.normal(size=(C * m, d)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (Ab, tau_up, tau_b, X)]
    j = [jax.numpy.asarray(a) for a in (Ab, tau_up, tau_b, X)]
    np.testing.assert_allclose(blocks.block_relay_mix(t[3], t[0], t[2]).numpy(),
                               np.asarray(jblocks.block_relay_mix(j[3], j[0], j[2])),
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(blocks.block_effective_weights(t[0], t[1], t[2]).numpy(),
                               np.asarray(jblocks.block_effective_weights(j[0], j[1], j[2])),
                               rtol=1e-6, atol=1e-6)
    for fused in (False, True):
        np.testing.assert_allclose(
            blocks.block_colrel_round_delta(t[3], t[0], t[1], t[2], fused=fused).numpy(),
            np.asarray(jblocks.block_colrel_round_delta(j[3], j[0], j[1], j[2], fused=fused)),
            rtol=1e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# 2. every port path against a live reference run
# ---------------------------------------------------------------------------


class FixedTrace:
    """A channel serving a given block-form trace, for both packages."""

    def __init__(self, model, ups, dds):
        self.model, self.ups, self.dds = model, ups, dds

    @property
    def n(self):
        return self.ups.shape[1]

    def tau_for_round(self, r):
        return self.ups[r], self.dds[r]

    def model_for_round(self, r):
        return self.model


def _quadratic_problem():
    p, Pb, Eb = _random_blocks(C=3, m=5, seed=0)
    return ExperimentSpec(model="quadratic"), p, Pb, Eb


def _cnn_problem():
    jm = jtopology.clustered_blocks(10, 0.5, 5, p_intra=0.8, rho=1.0)
    return (ExperimentSpec(model="cifar_cnn", local_steps=2, data_size=640, eval_size=64,
                           batch_size=8), jm.p, jm.Pb, jm.Eb)


PROBLEMS = {"quadratic": _quadratic_problem, "cifar_cnn": _cnn_problem}


@pytest.fixture(scope="module")
def reference():
    """Problem -> (inputs shared by both packages, reference TrainLog,
    reference final params) of the reference's ``clustered`` run with
    ``fused=False``, built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            spec, p, Pb, Eb = PROBLEMS[name]()
            jmodel = jblocks.ClusteredLinkModel(p, Pb, Eb)
            ups, dds = JClusteredStaticChannel(jmodel, seed=3).trace(0, ROUNDS)
            ups, dds = np.asarray(ups, np.float64), np.asarray(dds, np.float64)
            Ab = joptimize_weights_clustered(jmodel, sweeps=20, fine_tune_sweeps=20).Ab
            jspec = jexperiment.ExperimentSpec(**{k: getattr(spec, k) for k in (
                "model", "local_steps", "data_size", "eval_size", "batch_size")})
            loss_fn, init, clients, copt, sopt, T, _ = jexperiment._MODEL_BUILDERS[
                jspec.model](jspec, jmodel.n)
            init_np = jax.tree.map(np.array, init)
            tr = JFLTrainer(loss_fn, init, None, Ab, clients, copt, sopt, local_steps=T,
                            strategy=jstrategies.get("clustered", fused=False),
                            channel=FixedTrace(jmodel, ups, dds))
            tr.run(ROUNDS)
            inputs = dict(spec=spec, p=p, Pb=Pb, Eb=Eb, ups=ups, dds=dds, Ab=Ab, init=init_np)
            cache[name] = (inputs, tr.log, jax.tree.map(np.array, tr.params))
        return cache[name]

    return get


def _port_run(inputs, strategy, segment_d=0, *, ups=None, dds=None, model=None, Ab=None):
    model = model if model is not None else blocks.ClusteredLinkModel(
        inputs["p"], inputs["Pb"], inputs["Eb"])
    loss_fn, _, clients, copt, sopt, T, _ = build_task(inputs["spec"], model.n, "cpu")
    channel = FixedTrace(model, inputs["ups"] if ups is None else ups,
                         inputs["dds"] if dds is None else dds)
    tr = FLTrainer(loss_fn, params_from_jax(inputs["init"], "cpu"), None,
                   inputs["Ab"] if Ab is None else Ab, clients, copt, sopt, local_steps=T,
                   strategy=strategy, channel=channel, segment_d=segment_d, device="cpu")
    tr.run(ROUNDS)
    return tr


@pytest.mark.parametrize("segment_d", [0, 1])
@pytest.mark.parametrize("fused", [False, "collapse", "kernel"])
@pytest.mark.parametrize("problem", ["quadratic", "cifar_cnn"])
def test_clustered_tracks_reference(reference, problem, fused, segment_d):
    inputs, jlog, jfinal = reference(problem)
    tr = _port_run(inputs, strategies.get("clustered", fused=fused), segment_d)
    log = tr.log
    assert log.rounds == jlog.rounds == list(range(ROUNDS))
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jlog.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    assert tree.paths(tr.params) == tree.paths(jfinal)
    for got, want in zip(tree.leaves(tr.params), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# 3. C = 1 clustered against the port's colrel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,segment_d,bitwise", [
    ("kernel", 0, True), ("kernel", 1, True), ("collapse", 0, False), (False, 0, False)])
def test_clustered_c1_equals_colrel(fused, segment_d, bitwise):
    """The whole population as one cluster: the (n, n) operands become
    (1, n, n) blocks and the clustered run replays colrel's."""
    dense = topology.fully_connected(8, 0.6, p_c=0.7, rho=0.5)
    A = optimize_weights(dense, sweeps=10, fine_tune_sweeps=10).A
    ups, dds = StaticChannel(dense, seed=1).trace(0, ROUNDS)
    inputs = dict(spec=ExperimentSpec(model="quadratic"), ups=ups, dds=dds, Ab=A,
                  init={"x": np.zeros(16, np.float32)})
    colrel = _port_run(inputs, strategies.get("colrel", fused=fused), segment_d, model=dense)
    c1 = _port_run(inputs, strategies.get("clustered", fused=fused), segment_d,
                   dds=dds[:, None], model=blocks.ClusteredLinkModel.from_dense(dense, 8),
                   Ab=A[None])
    assert c1.log.participation == colrel.log.participation
    np.testing.assert_allclose(c1.log.weight_sums, colrel.log.weight_sums, rtol=0, atol=1e-6)
    if bitwise:
        assert c1.log.loss == colrel.log.loss
        assert torch.equal(c1.params["x"], colrel.params["x"])
    else:
        np.testing.assert_allclose(c1.log.loss, colrel.log.loss, rtol=1e-6)
        np.testing.assert_allclose(c1.params["x"].numpy(), colrel.params["x"].numpy(),
                                   rtol=0, atol=1e-6)


def test_clustered_refuses_dense_weights():
    """``build_experiment`` builds dense runs; the clustered strategy says
    what it takes instead of failing on a shape."""
    exp = build_experiment(ExperimentSpec(model="quadratic", strategy="clustered"),
                           device="cpu")
    with pytest.raises(ValueError, match=r"\(C, m, m\) block"):
        exp.run(1)

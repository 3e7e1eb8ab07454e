"""K-hop relaying and the strategies' ``calibrate`` hook against the
reference, on the CPU (after ``tests/test_strategies.py``'s multihop tests).

* ``multihop_correction`` is numpy over the same ``sample_rounds`` in both
  packages: bitwise for a seed.
* ``weights`` and ``aggregate`` on the same taus and alpha: atol 1e-6
  against the reference (f32 matrix products in another order); the
  dense K-stage path against the scalar collapse at atol 1e-5 (the
  reference test's 1e-4 for its inputs, tightened for unit-scale ones).
* At ``hops=1`` the collapse is colrel's, bitwise within the port.
* ``build_experiment`` calibrates multihop (alone and inside
  ``quantized``) as the reference does, and the runs track the reference
  at ``tests/test_torch_slice.py``'s tolerances; under ``adaptive`` it
  stays uncalibrated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.core import topology as jtopology
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro_torch import strategies, tree
from repro_torch.channel import StaticChannel
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.core.connectivity import sample_round
from repro_torch.core.weights import optimize_weights
from repro_torch.fl.experiment import ExperimentSpec, build_experiment, build_task
from repro_torch.fl.trainer import FLTrainer
from test_torch_slice import SPECS

ROUNDS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fig2a_copt():
    return optimize_weights(topology.paper_fig2a(), sweeps=15, fine_tune_sweeps=15).A


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_multihop_correction_equals_reference_bitwise(fig2a_copt, hops):
    got = strategies.multihop_correction(topology.paper_fig2a(), fig2a_copt, hops,
                                         draws=2048, seed=hops)
    want = jstrategies.multihop_correction(jtopology.paper_fig2a(), fig2a_copt, hops,
                                           draws=2048, seed=hops)
    np.testing.assert_array_equal(got, want)


def _round_inputs(n=8, seed=2):
    m = topology.fully_connected(n, 0.5, p_c=0.6, rho=0.3)
    rng = np.random.default_rng(seed)
    tu, td = sample_round(m, rng)
    A = np.abs(rng.normal(size=(n, n))) * 0.3 + np.eye(n)
    upd = rng.normal(size=(n, 5)).astype(np.float32)
    return m, tu, td, A, upd


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_multihop_weights_and_aggregate_match_reference(hops, calibrated):
    m, tu, td, A, upd = _round_inputs()
    ours, theirs = strategies.get("multihop", hops=hops), jstrategies.get("multihop", hops=hops)
    if calibrated:
        ours, theirs = ours.calibrate(m, A), theirs.calibrate(jtopology.fully_connected(
            8, 0.5, p_c=0.6, rho=0.3), A)
        np.testing.assert_array_equal(ours.correction, np.asarray(theirs.correction))
        assert ours.calibration_tracks_A and theirs.calibration_tracks_A
        assert ours.calibrate(m, A) is ours  # calibrated once
    t = [torch.as_tensor(x, dtype=torch.float32) for x in (tu, td, A, upd)]
    j = [jnp.asarray(x, jnp.float32) for x in (tu, td, A, upd)]
    w = ours.weights(*t[:3])
    np.testing.assert_allclose(w.numpy(), np.asarray(theirs.weights(*j[:3])), rtol=0, atol=1e-6)
    delta, _ = ours.aggregate(t[3], *t[:3])
    jdelta, _ = theirs.aggregate(j[3], *j[:3])
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=0, atol=1e-6)
    # the dense K-stage path against the scalar collapse
    np.testing.assert_allclose(delta.numpy(), (w @ t[3]).numpy(), rtol=0, atol=1e-5)


def test_multihop_weights_match_matrix_power():
    m, tu, td, A, upd = _round_inputs()
    for K in (1, 2, 3):
        got = strategies.get("multihop", hops=K).weights(
            *(torch.as_tensor(x, dtype=torch.float32) for x in (tu, td, A)))
        want = tu @ np.linalg.matrix_power(A * td.T, K) / 8
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_multihop_k1_is_colrel_collapse_bitwise():
    model = topology.paper_fig2b()
    A = optimize_weights(model, sweeps=10, fine_tune_sweeps=10).A
    rng = np.random.default_rng(3)
    hop, col = strategies.get("multihop", hops=1), strategies.get("colrel", fused="collapse")
    At = torch.as_tensor(A, dtype=torch.float32)
    for _ in range(8):
        tu, td = (torch.as_tensor(x, dtype=torch.float32) for x in sample_round(model, rng))
        assert torch.equal(hop.weights(tu, td, At), col.weights(tu, td, At))

    def run(strategy):
        loss_fn, init, clients, copt, sopt, T, _ = build_task(ExperimentSpec(model="quadratic"),
                                                              10, "cpu")
        t = FLTrainer(loss_fn, init, None, A, clients, copt, sopt, local_steps=T,
                      strategy=strategy, channel=StaticChannel(model, seed=3), device="cpu")
        t.run(6)
        return t

    a, b, c = run(hop), run(col), run(strategies.get("colrel"))
    for x, y, z in zip(tree.leaves(a.params), tree.leaves(b.params), tree.leaves(c.params)):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, atol=1e-6, rtol=1e-6)  # the faithful two-stage path
    assert a.log.weight_sums == b.log.weight_sums


def test_multihop_calibration_restores_unbiasedness():
    """At K=1 COPT-alpha's condition (5) makes the correction ~1; at K=2 it
    deviates, and dividing by it restores E[sum w] = 1."""
    m = topology.paper_fig2a()
    res = optimize_weights(m, sweeps=15, fine_tune_sweeps=15)
    c1 = strategies.multihop_correction(m, res.A, 1, draws=4096, seed=0)
    np.testing.assert_allclose(c1, np.ones(m.n), atol=0.12)
    s2 = strategies.get("multihop", hops=2).calibrate(m, res.A)
    assert s2.correction is not None
    rng = np.random.default_rng(9)
    At = torch.as_tensor(res.A, dtype=torch.float32)
    R, tot = 2000, 0.0
    for _ in range(R):
        tu, td = (torch.as_tensor(x, dtype=torch.float32) for x in sample_round(m, rng))
        tot += float(torch.sum(s2.weights(tu, td, At)))
    assert abs(tot / R - 1.0) < 0.1, tot / R


def test_hop_mixing_hook_is_used_at_every_further_hop():
    seen = []

    class Traced(strategies.MultiHopStrategy):
        def hop_mixing(self, k, M, tau_dd):
            seen.append(k)
            return M * 0.5

    _, tu, td, A, upd = _round_inputs()
    t = [torch.as_tensor(x, dtype=torch.float32) for x in (tu, td, A, upd)]
    base = strategies.get("multihop", hops=3).weights(*t[:3])
    got = Traced(hops=3).weights(*t[:3])
    assert seen == [1, 2]
    torch.testing.assert_close(got, base * 0.25)
    Traced(hops=3).aggregate(t[3], *t[:3])
    assert seen == [1, 2, 0, 1, 2]
    with pytest.raises(ValueError, match="hops must be >= 1"):
        strategies.get("multihop", hops=0)


# -- build_experiment: the calibrate hook -------------------------------------------

CALIBRATED = {
    "multihop": ("multihop", {"hops": 2}),
    "quantized(multihop)": ("quantized", {"codec": "identity", "inner": "multihop",
                                          "inner_options": {"hops": 2}}),
}


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(model, path):
        if (model, path) not in cache:
            strategy, options = CALIBRATED[path]
            exp = jbuild_experiment(JExperimentSpec(**SPECS[model], strategy=strategy,
                                                    strategy_options=options))
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(ROUNDS)
            cache[model, path] = (init, exp, jax.tree.map(np.array, exp.trainer.params))
        return cache[model, path]

    return get


@pytest.mark.parametrize("path", sorted(CALIBRATED))
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_calibrated_experiment_tracks_reference(reference, model, path):
    init, jexp, jfinal = reference(model, path)
    strategy, options = CALIBRATED[path]
    exp = build_experiment(ExperimentSpec(**SPECS[model], strategy=strategy,
                                          strategy_options=options), device="cpu")
    hop = exp.strategy.inner if strategy == "quantized" else exp.strategy
    jhop = jexp.strategy.inner if strategy == "quantized" else jexp.strategy
    assert hop.correction is not None and exp.strategy.calibration_tracks_A
    np.testing.assert_array_equal(hop.correction, np.asarray(jhop.correction))
    np.testing.assert_array_equal(exp.A, jexp.A)
    exp.trainer.params = params_from_jax(init, "cpu")
    log, jlog = exp.run(ROUNDS), jexp.log
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jlog.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    for got, want in zip(tree.leaves(exp.params), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_adaptive_leaves_multihop_uncalibrated():
    spec = ExperimentSpec(model="quadratic", topology="fig2a", strategy="multihop",
                          strategy_options={"hops": 2}, adaptive=True, reopt_every=10, rounds=3)
    exp = build_experiment(spec, device="cpu")
    assert exp.strategy.correction is None and not exp.strategy.calibration_tracks_A
    log = exp.run()
    assert np.isfinite(log.loss).all()


def test_quantized_passes_calibration_to_its_inner_strategy():
    m = topology.paper_fig2a()
    q = strategies.get("quantized", codec="topk", inner="multihop", inner_options={"hops": 2})
    assert not q.calibration_tracks_A
    qc = q.calibrate(m, np.eye(10))
    assert qc is not q and qc.calibration_tracks_A and qc.inner.correction is not None
    assert qc.codec is q.codec and qc.fused == q.fused
    assert qc.calibrate(m, np.eye(10)) is qc
    # an inner scheme with nothing to calibrate leaves the strategy as it is
    plain = strategies.get("quantized", codec="topk")
    assert plain.calibrate(m, np.eye(10)) is plain


def test_multihop_chunk_equals_per_round():
    spec = ExperimentSpec(model="quadratic", strategy="multihop", strategy_options={"hops": 2})
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(6)
    b.run(6, chunk=3)
    for field in ("loss", "participation", "uplink_bits", "weight_sums"):
        assert getattr(a.log, field) == getattr(b.log, field), field
    for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(x, y)

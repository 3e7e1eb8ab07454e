"""The trainer's adaptive alpha re-optimization against live reference runs,
on the CPU, and its chunked twin within the port.

1. The reference's adaptive Markov setup (``tests/test_fl_round.py``'s
   ``test_trainer_with_markov_channel_and_adaptive_alpha``: fig2a, a
   Gilbert–Elliott channel of memory 0.8, re-opt every 10 rounds after 5,
   3 + 3 sweeps, a FedAvg start, the quadratic task at T=2) through both
   trainers.  The port's Markov channel draws another stream than the
   reference's (numpy against ``jax.random``), so the port is served the
   reference channel's taus; then the re-opt rounds, ``S_est``,
   ``S_true``, ``est_p_err`` and the swapped alphas are equal, and the
   losses agree at rtol 1e-5.
2. ``build_experiment`` on the mobility channel with ``adaptive=True``:
   mobility is host numpy in both packages, so both draw the same taus;
   the port is given the reference's init.  Six rounds (one re-opt, one
   round on the swapped alpha), held at the tolerances of
   ``tests/test_torch_slice.py`` (participation and uplink_bits equal,
   weight_sum at atol 1e-6, loss at rtol 1e-5, params at atol 1e-6), the
   adaptive logs and the final alpha equal.
3. Within the port, bitwise: a chunked adaptive run against its per-round
   run, alpha swaps included; ``_effective_chunk``'s cases; and the
   guards.
"""

import jax
import numpy as np
import pytest
import torch

from repro.channel import AdaptiveConfig as JAdaptiveConfig
from repro.channel import AdaptiveWeightSchedule as JAdaptiveWeightSchedule
from repro.channel import MarkovChannel as JMarkovChannel
from repro.channel import gilbert_elliott as jgilbert_elliott
from repro.core import topology as jtopology
from repro.core.weights import fedavg_weights as jfedavg_weights
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import _build_quadratic as jbuild_quadratic
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro.fl.trainer import FLTrainer as JFLTrainer
from repro_torch import strategies, tree
from repro_torch.channel import (
    AdaptiveConfig,
    AdaptiveWeightSchedule,
    MarkovChannel,
    StaticChannel,
    gilbert_elliott,
)
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.core.weights import fedavg_weights
from repro_torch.fl.experiment import ExperimentSpec, build_experiment, build_task
from repro_torch.fl.trainer import FLTrainer
from test_torch_slice import SPECS

CFG = dict(every=10, warmup=5, sweeps=3, fine_tune_sweeps=3)
ADAPTIVE_FIELDS = ("reopt_rounds", "S_est", "S_true", "est_p_err")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Tiny CPU convolutions run fastest and most repeatably on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ReplayChannel:
    """A recorded tau stream served per round and in bulk, with the model
    the recording's channel reports."""

    def __init__(self, ups, dds, model):
        self.ups, self.dds, self.model = np.array(ups), np.array(dds), model
        self.n = ups.shape[1]

    def tau_for_round(self, r):
        return self.ups[r], self.dds[r]

    def trace(self, start, rounds):
        return self.ups[start:start + rounds], self.dds[start:start + rounds]

    def model_for_round(self, r):
        return self.model


def _jmarkov():
    return JMarkovChannel(jgilbert_elliott(jtopology.paper_fig2a(), memory=0.8), seed=1,
                          block=16)


def _port_quadratic(channel, adaptive, strategy="colrel"):
    loss_fn, init, clients, copt, sopt, T, _ = build_task(ExperimentSpec(model="quadratic"),
                                                          10, "cpu")
    return FLTrainer(loss_fn, init, None, fedavg_weights(10), clients, copt, sopt,
                     local_steps=T, strategy=strategy, seed=0, channel=channel,
                     adaptive=adaptive, device="cpu")


def _static():
    return StaticChannel(topology.paper_fig2a(), seed=0)


def test_adaptive_markov_trainer_tracks_reference():
    jloss, jinit, jclients, jcopt, jsopt, T, _ = jbuild_quadratic(
        JExperimentSpec(model="quadratic"), 10)
    jt = JFLTrainer(jloss, jinit, jtopology.paper_fig2a(), jfedavg_weights(10), jclients,
                    jcopt, jsopt, local_steps=T, strategy="colrel", seed=0,
                    channel=_jmarkov(), adaptive=JAdaptiveWeightSchedule(
                        10, JAdaptiveConfig(**CFG)))
    jt.run(30)
    jt.run(5)
    ups, dds = _jmarkov().trace(0, 35)
    t = _port_quadratic(ReplayChannel(ups, dds, topology.paper_fig2a()),
                        AdaptiveWeightSchedule(10, AdaptiveConfig(**CFG)))
    t.run(30)
    assert t.log.reopt_rounds == [9, 19, 29]
    t.run(5)
    assert t.log.rounds == jt.log.rounds == list(range(35))
    for field in ADAPTIVE_FIELDS:
        assert getattr(t.log, field) == getattr(jt.log, field), field
    assert t.adaptive.events == jt.adaptive.events
    np.testing.assert_array_equal(t.A.numpy(), np.asarray(jt.A))
    assert t.A.dtype == torch.float32
    assert t.log.participation == jt.log.participation
    np.testing.assert_allclose(t.log.weight_sums, jt.log.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.log.loss, jt.log.loss, rtol=1e-5, atol=0)
    assert np.isfinite(t.log.loss).all()


# one re-opt (round 4, after the warm-up of min(reopt_every, 20) = 5 rounds)
# and a round trained on the swapped alpha; further rounds amplify the
# packages' last-bit differences past the slice's atol (the static main path
# as well: 8e-7 after 3 rounds, 1.3e-5 after 10)
MOBILITY_ROUNDS = 6


@pytest.fixture(scope="module")
def mobility_reference():
    """model kind -> (init params, TrainLog, final params, final A) of the
    reference's adaptive mobility run, built once per module."""
    cache = {}

    def get(model):
        if model not in cache:
            exp = jbuild_experiment(JExperimentSpec(**SPECS[model], channel="mobility",
                                                    adaptive=True, reopt_every=5))
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(MOBILITY_ROUNDS)
            cache[model] = (init, exp.log, jax.tree.map(np.array, exp.trainer.params),
                            np.asarray(exp.trainer.A), exp)
        return cache[model]

    return get


@pytest.mark.parametrize("fused,segment_d", [(False, 0), ("kernel", 0), ("kernel", 1)])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_adaptive_mobility_experiment_tracks_reference(mobility_reference, model, fused,
                                                        segment_d):
    init, jlog, jfinal, jA, jexp = mobility_reference(model)
    exp = build_experiment(ExperimentSpec(**SPECS[model], channel="mobility", adaptive=True,
                                          reopt_every=5, strategy_options={"fused": fused},
                                          segment_d=segment_d), device="cpu")
    # the assembly: alpha starts blind, the round-0 model is mobility's own
    assert exp.copt_result is None and jexp.copt_result is None
    np.testing.assert_array_equal(exp.A, jexp.A)
    for field in ("p", "P", "E"):
        np.testing.assert_array_equal(getattr(exp.link_model, field),
                                      getattr(jexp.link_model, field))
    assert exp.trainer.adaptive.cfg.__dict__ == jexp.trainer.adaptive.cfg.__dict__
    exp.trainer.params = params_from_jax(init, "cpu")
    log = exp.run(MOBILITY_ROUNDS)

    assert log.reopt_rounds == jlog.reopt_rounds == [4]
    for field in ADAPTIVE_FIELDS:
        assert getattr(log, field) == getattr(jlog, field), field
    np.testing.assert_array_equal(exp.trainer.A.numpy(), jA)
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jlog.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    for got, want in zip(tree.leaves(exp.params), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _assert_same(a: FLTrainer, b: FLTrainer):
    """Logs (the adaptive ones too), alpha, params, server and strategy
    state, bitwise."""
    for field in ("rounds", "loss", "participation", "uplink_bits", "weight_sums",
                  *ADAPTIVE_FIELDS):
        av, bv = getattr(a.log, field), getattr(b.log, field)
        assert len(av) == len(bv) and all(x == y or (x != x and y != y)
                                          for x, y in zip(av, bv)), field
    assert torch.equal(a.A, b.A)
    for state in ("params", "server_state", "agg_state"):
        for x, y in zip(tree.leaves(getattr(a, state)), tree.leaves(getattr(b, state))):
            assert torch.equal(x, y), state


def test_chunked_adaptive_markov_equals_per_round():
    def make():
        return _port_quadratic(
            MarkovChannel(gilbert_elliott(topology.paper_fig2a(), memory=0.8), seed=1, block=16),
            AdaptiveWeightSchedule(10, AdaptiveConfig(**CFG)))

    a, b = make(), make()
    a.run(30)
    b.run(30, chunk=5)
    _assert_same(a, b)
    assert b.log.reopt_rounds == [9, 19, 29]
    assert a.adaptive.events == b.adaptive.events
    assert not torch.equal(b.A, torch.as_tensor(fedavg_weights(10), dtype=torch.float32))


@pytest.mark.parametrize("mode", ["per_client", "async"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_chunked_adaptive_mobility_equals_per_round(model, mode):
    spec = ExperimentSpec(**SPECS[model], channel="mobility", adaptive=True, reopt_every=4,
                          strategy_options={"fused": "kernel"}, mode=mode)
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(8)
    b.run(2)   # per round: the chunks align at round 4
    b.run(6, chunk=2)
    _assert_same(a.trainer, b.trainer)
    assert b.log.reopt_rounds == [3, 7]


def test_effective_chunk_follows_the_reopt_cadence():
    t = _port_quadratic(_static(), AdaptiveWeightSchedule(
        10, AdaptiveConfig(every=10, warmup=5)))
    assert t._effective_chunk(7, 0) == 1   # 10 % 7 != 0
    assert t._effective_chunk(5, 0) == 5
    assert t._effective_chunk(5, 8) == 1   # eval cadence misaligned
    assert t._effective_chunk(5, 10) == 5
    assert t._effective_chunk(1, 0) == 1
    # a misaligned chunk runs per round, and still re-optimizes on time
    t.run(20, chunk=7)
    assert t._scan_fn is None and t.log.reopt_rounds == [9, 19]


def test_reopt_mid_chunk_raises():
    t = _port_quadratic(_static(), AdaptiveWeightSchedule(
        10, AdaptiveConfig(every=2, warmup=1)))
    with pytest.raises(RuntimeError, match="fired mid-chunk"):
        t._run_chunks(0, 1, 4, 0, False)


def test_adaptive_guards():
    sched = lambda: AdaptiveWeightSchedule(10, AdaptiveConfig(every=10, warmup=5))  # noqa: E731
    # a strategy that ignores A
    with pytest.raises(ValueError, match="ignores it"):
        _port_quadratic(_static(), sched(), strategy="fedavg_blind")
    with pytest.raises(ValueError, match="ignores it"):
        build_experiment(ExperimentSpec(model="quadratic", topology="fig2a",
                                        strategy="fedavg_blind", adaptive=True), device="cpu")
    # a calibration tied to one alpha
    calibrated = strategies.get("multihop", hops=2).calibrate(topology.paper_fig2a(),
                                                              np.eye(10))
    with pytest.raises(ValueError, match="calibrated against a fixed alpha"):
        _port_quadratic(_static(), sched(), strategy=calibrated)
    # the estimator needs the taus on the host
    t = _port_quadratic(_static(), sched())
    with pytest.raises(ValueError, match="incompatible with adaptive"):
        t.run(2, no_trace=True)
    # and mobility has no in-scan sampler at all
    exp = build_experiment(ExperimentSpec(model="quadratic", channel="mobility"), device="cpu")
    with pytest.raises(ValueError, match="scan_sampler"):
        exp.run(2, no_trace=True)


def test_adaptive_auto_alpha_starts_blind():
    exp = build_experiment(ExperimentSpec(model="quadratic", adaptive=True, reopt_every=5),
                           device="cpu")
    np.testing.assert_array_equal(exp.A, fedavg_weights(10))
    assert exp.copt_result is None
    assert exp.trainer.adaptive.cfg == AdaptiveConfig(every=5, warmup=5, decay=1.0,
                                                      prune_below=0.02)
    mob = build_experiment(ExperimentSpec(model="quadratic", channel="mobility_fast",
                                          adaptive=True, reopt_every=50), device="cpu")
    assert mob.trainer.adaptive.cfg == AdaptiveConfig(every=50, warmup=20, decay=0.995,
                                                      prune_below=0.02)
    # without adaptive, "auto" is COPT-alpha on mobility's own round-0 model
    oracle = build_experiment(ExperimentSpec(model="quadratic", channel="mobility"),
                              device="cpu")
    jexp = jbuild_experiment(JExperimentSpec(model="quadratic", channel="mobility"))
    np.testing.assert_array_equal(oracle.A, jexp.A)
    assert oracle.trainer.adaptive is None


@pytest.mark.parametrize("kw", [
    dict(channel="mobility", adaptive=True),
    dict(channel="mobility_fast"),
    dict(strategy="multihop", strategy_options={"hops": 2}),
    dict(strategy="quantized", strategy_options={"codec": "topk"}),
    dict(strategy="quantized", strategy_options={"codec": "randk"}),
], ids=["mobility adaptive", "mobility_fast", "multihop", "topk", "randk"])
def test_new_paths_need_cuda_unless_told_otherwise(monkeypatch, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ExperimentSpec(model="quadratic", **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_experiment(spec)
    log = build_experiment(spec, device="cpu").run(2)
    assert np.isfinite(log.loss).all()

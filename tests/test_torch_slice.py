"""The port's main path end to end against the reference: two rounds of
``build_experiment`` for the quadratic task and the reduced CIFAR CNN.

Both packages get the same spec and seed, so the same data, batches, taus
and COPT-alpha weights; the port is given the reference's init params
through ``params_from_jax``.  Every ColRel execution of the port
(``fused`` in {False, "collapse", "kernel"}, ``segment_d`` in {0, 1}) is
held to the reference's faithful path (``fused=False``), which they all
compute exactly in real arithmetic.  So is every execution of the
``memory`` strategy (``fused`` in {False, "kernel"}, ``segment_d`` in
{0, 1}), against the reference's ``memory`` run, and
``quantized(codec="identity")`` against the reference's.  The static
channel gives both packages the same taus; the Markov channel's draws
differ between them and are held by their law in
``tests/test_torch_channel.py``.

Tolerances: ``participation`` and ``uplink_bits`` are counts and must be
equal; ``weight_sum`` sums ten products of f32 weights and is held at
1e-6 (NaN in both packages for the strategies that do not collapse).  Losses and final params come out of f32 SGD whose convolutions and
reductions sum in another order in XLA than in PyTorch; the differences
stay near 1e-7 after two rounds, held at rtol 1e-5 (losses) and atol 1e-6
(params).
"""

import jax
import numpy as np
import pytest
import torch

from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.fl.experiment import ExperimentSpec, build_experiment

ROUNDS = 2
SPECS = {
    "quadratic": dict(model="quadratic"),
    "cifar_cnn": dict(model="cifar_cnn", local_steps=2, data_size=640, eval_size=64,
                      batch_size=8),
}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Tiny CPU convolutions run fastest and most repeatably on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# strategy -> the options of the reference run the port is held to
REFERENCE_OPTIONS = {
    "colrel": {"fused": False},
    "memory": {"fused": False},
    "quantized": {"codec": "identity"},
}


@pytest.fixture(scope="module")
def reference():
    """(model kind, strategy) -> (init params, TrainLog, final params) of the
    reference's run with ``REFERENCE_OPTIONS[strategy]``, built once per
    module."""
    cache = {}

    def get(model, strategy="colrel"):
        if (model, strategy) not in cache:
            exp = jbuild_experiment(JExperimentSpec(
                **SPECS[model], strategy=strategy,
                strategy_options=REFERENCE_OPTIONS[strategy]))
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(ROUNDS)
            cache[model, strategy] = (init, exp.log, jax.tree.map(np.array, exp.trainer.params))
        return cache[model, strategy]

    return get


def _check_tracks(reference, model, strategy, options, segment_d):
    init, jlog, jfinal = reference(model, strategy)
    exp = build_experiment(ExperimentSpec(**SPECS[model], strategy=strategy,
                                          strategy_options=options,
                                          segment_d=segment_d), device="cpu")
    exp.trainer.params = params_from_jax(init, "cpu")
    log = exp.run(ROUNDS)

    assert log.rounds == jlog.rounds == list(range(ROUNDS))
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jlog.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    final = exp.params
    assert tree.paths(final) == tree.paths(jfinal)
    for got, want in zip(tree.leaves(final), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    return exp


@pytest.mark.parametrize("segment_d", [0, 1])
@pytest.mark.parametrize("fused", [False, "collapse", "kernel"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_port_tracks_reference(reference, model, fused, segment_d):
    _check_tracks(reference, model, "colrel", {"fused": fused}, segment_d)


@pytest.mark.parametrize("segment_d", [0, 1])
@pytest.mark.parametrize("fused", [False, "kernel"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_memory_tracks_reference(reference, model, fused, segment_d):
    """The replay buffer is carried across the two rounds; some client is
    blocked in each of them, so the replay branch runs."""
    exp = _check_tracks(reference, model, "memory", {"fused": fused}, segment_d)
    assert min(exp.log.participation) < exp.trainer.rc.n_clients
    assert exp.trainer.agg_state.shape == (10, sum(x.numel() for x in tree.leaves(exp.params)))


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_quantized_identity_tracks_reference(reference, model):
    _check_tracks(reference, model, "quantized", {"codec": "identity"}, 0)


def test_unported_options_raise(tmp_path):
    """The telemetry and checkpointing fields, refused until ROADMAP items 14
    and 15 were ported, now build and run 4 rounds on the CPU (each has its
    own tests in ``test_torch_telemetry.py`` and ``test_torch_resume.py``);
    ``resume_from`` restores the round-4 checkpoint and trains to a target
    of 6.  What still raises is a value the reference refuses too."""
    ck = str(tmp_path / "c")
    for kw in (dict(ckpt_every=2, ckpt_dir=ck), dict(telemetry=True),
               dict(metrics_dir=str(tmp_path / "m")), dict(profile_dir=str(tmp_path / "p")),
               dict(profile_start=1, profile_dir=str(tmp_path / "p1")), dict(log_every=1),
               dict(ckpt_dir=ck, ckpt_keep=1), dict(resume_from=ck, rounds=6)):
        exp = build_experiment(ExperimentSpec(**{"model": "quadratic", "rounds": 4, **kw}),
                               device="cpu")
        exp.run()
        exp.close()
        end = exp.spec.rounds
        assert exp.trainer.round == end and exp.log.rounds == list(range(end))
    with pytest.raises(ValueError, match="rounds >= 1"):
        build_experiment(ExperimentSpec(model="quadratic", profile_dir=str(tmp_path / "p"),
                                        profile_rounds=0), device="cpu")


def test_experiment_spec_fields_match_reference():
    """The port's spec has the reference's fields, in its order, with its
    defaults, so a reference spec's fields build a port spec."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(ExperimentSpec)]
    assert names == [f.name for f in dataclasses.fields(JExperimentSpec)]
    ours, theirs = ExperimentSpec(), JExperimentSpec()
    for name in names:
        assert getattr(ours, name) == getattr(theirs, name), name
    # the ported new fields run: reopt_every is inert, donate and
    # async_options reach the trainer
    exp = build_experiment(ExperimentSpec(model="quadratic", reopt_every=7, donate=False,
                                          mode="async", async_options={"gamma": 0.5}),
                           device="cpu")
    assert not exp.trainer.donate and exp.trainer.strategy.gamma == 0.5

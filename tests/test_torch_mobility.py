"""The port's mobility channel, link estimator and adaptive schedule against
the reference, on the CPU.

All three are host numpy in both packages, with the same arithmetic in the
same order, so they are held bitwise: one seed gives the reference's
taus, positions, waypoints and per-epoch ``(p, P, E)``; the same taus give
the reference's estimator state, projected model and errors, and the
same re-optimization events and relay weights.
"""

import dataclasses

import numpy as np
import pytest

from repro.channel import AdaptiveConfig as JAdaptiveConfig
from repro.channel import AdaptiveWeightSchedule as JAdaptiveWeightSchedule
from repro.channel import LinkEstimator as JLinkEstimator
from repro.channel import MobilityChannel as JMobilityChannel
from repro.configs import channels as jchannels
from repro_torch.channel import (
    AdaptiveConfig,
    AdaptiveWeightSchedule,
    LinkEstimator,
    MarkovChannel,
    MobilityChannel,
    gilbert_elliott,
)
from repro_torch.configs import channels
from repro_torch.core import topology

MOBILITY_CASES = {
    "pedestrian": dict(seed=0),
    "vehicular": dict(seed=3, epoch=5, speed=15.0),
    "small area, permanent links": dict(seed=7, area=60.0, speed=9.0, epoch=3,
                                        d2d_mode="permanent"),
    "reciprocity": dict(seed=1, epoch=4, rho=0.5, ps_position=(20.0, -10.0)),
    "given start": dict(seed=2, epoch=2, init_positions=np.linspace(-50, 50, 20).reshape(10, 2)),
}


def _same_model(a, b):
    for field in ("p", "P", "E"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


@pytest.mark.parametrize("case", sorted(MOBILITY_CASES))
def test_mobility_equals_reference_bitwise(case):
    kw = MOBILITY_CASES[case]
    ours, theirs = MobilityChannel(10, **kw), JMobilityChannel(10, **kw)
    np.testing.assert_array_equal(ours.positions, theirs.positions)
    for r in range(45):
        got, want = ours.tau_for_round(r), theirs.tau_for_round(r)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"round {r}")
        np.testing.assert_array_equal(ours.positions, theirs.positions)
        np.testing.assert_array_equal(ours._waypoints, theirs._waypoints)
        _same_model(ours.model_for_round(r), theirs.model_for_round(r))
    assert sorted(ours._models) == sorted(theirs._models)
    for e in ours._models:
        _same_model(ours._models[e], theirs._models[e])


def test_mobility_trace_is_the_per_round_stream():
    per, bulk, ref = (MobilityChannel(10, seed=4, epoch=3), MobilityChannel(10, seed=4, epoch=3),
                      JMobilityChannel(10, seed=4, epoch=3))
    ups, dds = bulk.trace(0, 7)
    ups2, dds2 = bulk.trace(7, 5)
    jups, jdds = ref.trace(0, 12)
    np.testing.assert_array_equal(np.concatenate([ups, ups2]), jups)
    np.testing.assert_array_equal(np.concatenate([dds, dds2]), jdds)
    for r in range(12):
        u, d = per.tau_for_round(r)
        np.testing.assert_array_equal(u, jups[r])
        np.testing.assert_array_equal(d, jdds[r])
    assert ups.shape == (7, 10) and dds.shape == (7, 10, 10)


def test_mobility_refusals():
    ch = MobilityChannel(10, seed=0, epoch=5)
    with pytest.raises(ValueError, match="serves rounds in order"):
        ch.tau_for_round(1)
    ch.tau_for_round(0)
    with pytest.raises(ValueError, match="serves rounds in order"):
        ch.tau_for_round(0)
    with pytest.raises(ValueError, match="not reached yet"):
        ch.model_for_round(5)
    with pytest.raises(ValueError, match="epoch must be positive"):
        MobilityChannel(10, epoch=0)
    with pytest.raises(ValueError, match="init_positions"):
        MobilityChannel(10, init_positions=np.zeros((9, 2)))
    # the geometry lives on the host: no in-scan sampler, as in the reference
    assert not hasattr(ch, "scan_sampler")
    assert not hasattr(JMobilityChannel(10), "scan_sampler")


@pytest.mark.parametrize("name", ["mobility", "mobility_fast"])
def test_mobility_presets_have_the_reference_parameters(name):
    ours, theirs = channels.CHANNEL_PRESETS[name], jchannels.CHANNEL_PRESETS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    ch = channels.make_channel(name, topology.paper_fig2b(), seed=5)
    ch_n = channels.make_channel(name, n=10, seed=5)
    ref = jchannels.make_channel(name, n=10, seed=5)
    want = ref.trace(0, 25)
    for c in (ch, ch_n):
        assert isinstance(c, MobilityChannel) and c.n == 10
        assert (c.epoch, c.speed, c.area, c.d2d_mode) == (ref.epoch, ref.speed, ref.area,
                                                           ref.d2d_mode)
        for g, w in zip(c.trace(0, 25), want):
            np.testing.assert_array_equal(g, w)
        _same_model(c.model_for_round(24), ref.model_for_round(24))


def test_preset_fields_and_make_channel_signature_match_reference():
    import inspect

    assert ([f.name for f in dataclasses.fields(channels.ChannelPreset)]
            == [f.name for f in dataclasses.fields(jchannels.ChannelPreset)])
    assert sorted(channels.CHANNEL_PRESETS) == sorted(jchannels.CHANNEL_PRESETS)
    assert (list(inspect.signature(channels.make_channel).parameters)
            == list(inspect.signature(jchannels.make_channel).parameters))
    with pytest.raises(ValueError, match="needs n"):
        channels.make_channel("mobility")
    assert channels.make_channel("mobility_fast", n=7).n == 7


# -- the link estimator --------------------------------------------------------

def _markov_taus(rounds=120, seed=2):
    ch = MarkovChannel(gilbert_elliott(topology.paper_fig2a(), memory=0.8), seed=seed, block=32)
    return ch.trace(0, rounds)


def _mobility_taus(rounds=120, seed=2):
    return MobilityChannel(10, seed=seed, epoch=10, speed=15.0).trace(0, rounds)


def _same_estimator(ours, theirs, true_model):
    for attr in ("p_hat", "P_hat", "E_hat"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(theirs, attr), err_msg=attr)
    _same_model(ours.estimated_model(), theirs.estimated_model())
    assert ours.errors(true_model) == theirs.errors(true_model)
    assert ours.rounds == theirs.rounds and ours._t == theirs._t


@pytest.mark.parametrize("prune_below", [0.0, 0.02])
@pytest.mark.parametrize("decay", [1.0, 0.995])
@pytest.mark.parametrize("trace", ["markov", "mobility"])
def test_link_estimator_equals_reference_bitwise(trace, decay, prune_below):
    ups, dds = (_markov_taus if trace == "markov" else _mobility_taus)()
    kw = dict(decay=decay, prune_below=prune_below)
    ours, theirs = LinkEstimator(10, **kw), JLinkEstimator(10, **kw)
    true_model = topology.paper_fig2a()
    for r in range(len(ups)):
        ours.update(ups[r], dds[r])
        theirs.update(ups[r], dds[r])
        if r % 17 == 0:
            _same_estimator(ours, theirs, true_model)
    _same_estimator(ours, theirs, true_model)
    # the posterior round-trips through its checkpoint form
    again = LinkEstimator(10, **kw)
    again.restore_state(ours.checkpoint_state())
    _same_estimator(again, theirs, true_model)
    state, jstate = ours.checkpoint_state(), theirs.checkpoint_state()
    assert state.keys() == jstate.keys()
    for k in state:
        np.testing.assert_array_equal(state[k], jstate[k])


def test_link_estimator_refusals():
    with pytest.raises(ValueError, match="decay"):
        LinkEstimator(4, decay=0.0)
    with pytest.raises(ValueError, match="decay"):
        LinkEstimator(4, decay=1.5)
    with pytest.raises(ValueError, match="prior"):
        LinkEstimator(4, prior=(0.0, 1.0))


# -- the adaptive schedule -----------------------------------------------------

@pytest.mark.parametrize("trace", ["markov", "mobility"])
def test_adaptive_schedule_equals_reference_bitwise(trace):
    ups, dds = (_markov_taus if trace == "markov" else _mobility_taus)(rounds=60)
    kw = dict(every=10, warmup=15, sweeps=3, fine_tune_sweeps=3,
              decay=0.995 if trace == "mobility" else 1.0, prune_below=0.02)
    ours = AdaptiveWeightSchedule(10, AdaptiveConfig(**kw))
    theirs = JAdaptiveWeightSchedule(10, JAdaptiveConfig(**kw))
    fired = []
    for r in range(len(ups)):
        a, b = ours.step(r, ups[r], dds[r]), theirs.step(r, ups[r], dds[r])
        assert (a is None) == (b is None), r
        if a is not None:
            np.testing.assert_array_equal(a, b)
            fired.append(r)
    assert fired == [19, 29, 39, 49, 59]  # the first window with >= 15 rounds seen
    assert ours.events == theirs.events
    _same_estimator(ours.estimator, theirs.estimator, topology.paper_fig2a())


def test_adaptive_config_matches_reference():
    assert dataclasses.asdict(AdaptiveConfig()) == dataclasses.asdict(JAdaptiveConfig())
    with pytest.raises(ValueError, match="every must be positive"):
        AdaptiveConfig(every=0)

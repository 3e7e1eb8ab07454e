"""The port's Gilbert–Elliott channel against the reference's and against
its own law, dense and in clustered block form.

The chains' parameters and the numpy host loop are copied from the
reference, so they are held to it exactly: ``gilbert_elliott`` equal to
the last bit, and ``sample_ge_rounds_host`` given the same numpy seed
draws bitwise the reference's taus.  The port's ``MarkovChannel`` draws
its own numpy stream (the reference's comes from ``jax.random``), so it is
held by the law, as ``tests/test_channel.py`` holds the reference: every
statistic within 5 standard deviations of its target, the deviations
corrected for the chains' autocorrelation (effective sample size
``(1 - lam) / (1 + lam)``); lag-1 autocorrelation within 0.05; the mean
outage burst within 10% of ``1/g``.  The clustered channels
(``ClusteredStaticChannel``, ``ClusteredMarkovChannel``) are held the same
way on every intra-cluster link, and ``gilbert_elliott_clustered`` to the
reference's fit to the bit.
"""

import numpy as np
import pytest

from repro.channel import gilbert_elliott as jgilbert_elliott
from repro.channel import gilbert_elliott_clustered as jgilbert_elliott_clustered
from repro.core import blocks as jblocks
from repro.channel import sample_ge_rounds_host as jsample_ge_rounds_host
from repro.core import topology as jtopology
from repro_torch.channel import (
    ClusteredMarkovChannel,
    ClusteredStaticChannel,
    MarkovChannel,
    StaticChannel,
    gilbert_elliott,
    gilbert_elliott_clustered,
    sample_ge_rounds_host,
)
from repro_torch.configs.channels import CHANNEL_PRESETS, make_channel
from repro_torch.core import blocks, topology
from repro_torch.core.connectivity import reciprocity_matrix

N = 6
MODEL = topology.fully_connected(N, 0.6, p_c=0.5, rho=0.5)
JMODEL = jtopology.fully_connected(N, 0.6, p_c=0.5, rho=0.5)
OFF = ~np.eye(N, dtype=bool)


def _trace(channel, rounds):
    return channel.trace(0, rounds)


@pytest.mark.parametrize("memory", [0.0, 0.9, (0.5, 0.97)])
@pytest.mark.parametrize("occupancy", [None, 0.8])
def test_gilbert_elliott_params_equal_the_reference(memory, occupancy):
    for model, jmodel in ((MODEL, JMODEL),
                          (topology.paper_fig2b(), jtopology.paper_fig2b())):
        got = gilbert_elliott(model, memory=memory, occupancy=occupancy)
        want = jgilbert_elliott(jmodel, memory=memory, occupancy=occupancy)
        for field in ("pi_up", "lam_up", "pi_dd", "lam_dd"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        for a, b in zip(got.expected_bad_burst(), want.expected_bad_burst()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.lag1_uplink(), want.lag1_uplink())


def test_gilbert_elliott_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        gilbert_elliott(MODEL, memory=1.0)
    with pytest.raises(ValueError):
        gilbert_elliott(MODEL, memory=0.5, occupancy=0.0)


@pytest.mark.parametrize("memory", [0.0, 0.7])
def test_host_sampler_draws_the_reference_taus(memory):
    got = sample_ge_rounds_host(gilbert_elliott(MODEL, memory=memory),
                                np.random.default_rng(7), 300)
    want = jsample_ge_rounds_host(jgilbert_elliott(JMODEL, memory=memory),
                                  np.random.default_rng(7), 300)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lam", [0.0, 0.8])
def test_markov_channel_marginals_and_reciprocity(lam):
    R = 20000
    ups, dds = _trace(MarkovChannel(gilbert_elliott(MODEL, memory=lam), seed=0), R)
    assert ups.shape == (R, N) and dds.shape == (R, N, N)
    ess = (1 - lam) / (1 + lam)
    tol_up = 5 * np.sqrt(MODEL.p * (1 - MODEL.p) / (R * ess))
    assert np.all(np.abs(ups.mean(0) - MODEL.p) < tol_up + 1e-9)
    tol_dd = 5 * np.sqrt(np.maximum(MODEL.P * (1 - MODEL.P), 1e-12) / (R * ess))
    assert np.all(np.abs(dds.mean(0) - MODEL.P)[OFF] < (tol_dd + 1e-9)[OFF])
    # reciprocity: E[tau_ij tau_ji] = E_ij
    joint = (dds * np.swapaxes(dds, 1, 2)).mean(0)
    tol_e = 5 * np.sqrt(np.maximum(MODEL.E * (1 - MODEL.E), 1e-12) / (R * ess))
    assert np.all(np.abs(joint - MODEL.E)[OFF] < (tol_e + 1e-9)[OFF])
    assert np.all(dds[:, np.arange(N), np.arange(N)] == 1.0)


@pytest.mark.parametrize("lam", [0.0, 0.9])
def test_markov_channel_lag1_autocorrelation(lam):
    params = gilbert_elliott(MODEL, memory=lam)
    ups, _ = _trace(MarkovChannel(params, seed=1), 20000)
    got = np.mean([np.corrcoef(ups[:-1, i], ups[1:, i])[0, 1] for i in range(N)])
    assert abs(got - params.lag1_uplink()[0]) < 0.05, (lam, got)


def test_markov_channel_outage_bursts_last_one_over_g():
    """With the tightest gates (pi_up = p) an uplink is up exactly when its
    gate is Good, so its outages are the gate's Bad sojourns: geometric
    with mean 1/g."""
    params = gilbert_elliott(MODEL, memory=0.9)
    ups, _ = _trace(MarkovChannel(params, seed=2), 40000)
    runs = []
    for i in range(N):
        x = np.concatenate([[1.0], ups[:, i], [1.0]])
        edges = np.flatnonzero(np.diff(x))
        runs.extend(edges[1::2] - edges[::2])
    want = params.expected_bad_burst()[0][0]
    assert abs(np.mean(runs) / want - 1) < 0.1, (np.mean(runs), want)


def test_markov_channel_blocks_are_one_stream():
    """Per-round service, bulk service and block size give one stream for a
    seed; the stream cannot rewind past its block."""
    params = gilbert_elliott(MODEL, memory=0.9)
    per_round = MarkovChannel(params, seed=3, block=32)
    taus = [per_round.tau_for_round(r) for r in range(100)]
    bulk_u, bulk_d = MarkovChannel(params, seed=3, block=32).trace(0, 100)
    np.testing.assert_array_equal(np.array([t[0] for t in taus]), bulk_u)
    np.testing.assert_array_equal(np.array([t[1] for t in taus]), bulk_d)
    with pytest.raises(ValueError):
        per_round.tau_for_round(3)
    other = MarkovChannel(params, seed=4, block=32).trace(0, 100)[0]
    assert not np.array_equal(other, bulk_u)
    assert per_round.model_for_round(5) is MODEL


def test_markov_iid_preset_has_the_static_law():
    R = 20000
    ups, dds = _trace(make_channel("markov_iid", MODEL, seed=0), R)
    sups, sdds = _trace(StaticChannel(MODEL, seed=0), R)
    for got, want in ((ups.mean(0), sups.mean(0)), (dds.mean(0)[OFF], sdds.mean(0)[OFF])):
        # two independent estimates of p(1-p) <= 1/4 variables
        assert np.all(np.abs(got - want) < 5 * np.sqrt(2 * 0.25 / R))
    lag1 = np.mean([np.corrcoef(ups[:-1, i], ups[1:, i])[0, 1] for i in range(N)])
    assert abs(lag1) < 0.05


def test_presets_build_their_channels():
    assert isinstance(make_channel("static", MODEL, seed=1), StaticChannel)
    for name in ("markov_iid", "markov", "markov_heavy"):
        ch = make_channel(name, MODEL, seed=1)
        assert isinstance(ch, MarkovChannel)
        assert np.all(ch.params.lam_up[MODEL.p < 1] == CHANNEL_PRESETS[name].memory)
    with pytest.raises(KeyError, match="unknown channel preset"):
        make_channel("nope", MODEL)
    with pytest.raises(ValueError, match="LinkModel"):
        make_channel("markov")


# -- clustered (block-form) channels -------------------------------------------

def _clustered_model(C=3, m=4, seed=0, rho=0.6):
    """Distinct random blocks, as tests/test_clustered.py builds them."""
    rng = np.random.default_rng(seed)
    Pb = rng.uniform(0.4, 0.95, size=(C, m, m))
    for c in range(C):
        np.fill_diagonal(Pb[c], 1.0)
    Eb = np.stack([reciprocity_matrix(Pb[c], rho) for c in range(C)])
    p = rng.uniform(0.3, 0.9, size=C * m)
    return blocks.ClusteredLinkModel(p, Pb, Eb), jblocks.ClusteredLinkModel(p, Pb, Eb)


CMODEL, JCMODEL = _clustered_model()
COFF = ~np.eye(CMODEL.m, dtype=bool)


def _clustered_channel(kind, lam, seed, block=256):
    if kind == "static":
        return ClusteredStaticChannel(CMODEL, seed=seed, block=block)
    return ClusteredMarkovChannel(gilbert_elliott_clustered(CMODEL, memory=lam), seed=seed,
                                  block=block)


@pytest.mark.parametrize("memory", [0.0, 0.9, (0.5, 0.97)])
@pytest.mark.parametrize("occupancy", [None, 0.8])
def test_gilbert_elliott_clustered_params_equal_the_reference(memory, occupancy):
    got = gilbert_elliott_clustered(CMODEL, memory=memory, occupancy=occupancy)
    want = jgilbert_elliott_clustered(JCMODEL, memory=memory, occupancy=occupancy)
    for field in ("pi_up", "lam_up", "pi_dd", "lam_dd"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    with pytest.raises(ValueError):
        gilbert_elliott_clustered(CMODEL, memory=1.0)


@pytest.mark.parametrize("kind,lam", [("static", 0.0), ("markov", 0.0), ("markov", 0.8)])
def test_clustered_channel_marginals_and_reciprocity(kind, lam):
    R = 20000
    ups, dds = _trace(_clustered_channel(kind, lam, seed=0), R)
    C, m = CMODEL.C, CMODEL.m
    assert ups.shape == (R, C * m) and dds.shape == (R, C, m, m)
    ess = (1 - lam) / (1 + lam)
    p = CMODEL.p
    assert np.all(np.abs(ups.mean(0) - p) < 5 * np.sqrt(p * (1 - p) / (R * ess)) + 1e-9)
    Pb, Eb = CMODEL.Pb, CMODEL.Eb
    tol_dd = 5 * np.sqrt(np.maximum(Pb * (1 - Pb), 1e-12) / (R * ess))
    assert np.all((np.abs(dds.mean(0) - Pb) < tol_dd + 1e-9)[:, COFF])
    joint = (dds * np.swapaxes(dds, -1, -2)).mean(0)
    tol_e = 5 * np.sqrt(np.maximum(Eb * (1 - Eb), 1e-12) / (R * ess))
    assert np.all((np.abs(joint - Eb) < tol_e + 1e-9)[:, COFF])
    assert np.all(dds[:, :, np.arange(m), np.arange(m)] == 1.0)


@pytest.mark.parametrize("lam", [0.0, 0.9])
def test_clustered_markov_lag1_autocorrelation(lam):
    params = gilbert_elliott_clustered(CMODEL, memory=lam)
    ups, _ = _trace(ClusteredMarkovChannel(params, seed=1), 20000)
    p, pi = CMODEL.p, params.pi_up
    want = (p / pi) * (1 - pi) * params.lam_up / (1 - p)
    got = np.array([np.corrcoef(ups[:-1, i], ups[1:, i])[0, 1] for i in range(CMODEL.n)])
    assert np.all(np.abs(got - want) < 0.05), (lam, got, want)


def test_clustered_markov_outage_bursts_last_one_over_g():
    """Tightest gates (pi_up = p): an uplink's outages are its gate's Bad
    sojourns, geometric with mean 1/g, g = (1 - lam) pi."""
    params = gilbert_elliott_clustered(CMODEL, memory=0.9)
    ups, _ = _trace(ClusteredMarkovChannel(params, seed=2), 40000)
    runs, want = [], []
    for i in range(CMODEL.n):
        x = np.concatenate([[1.0], ups[:, i], [1.0]])
        edges = np.flatnonzero(np.diff(x))
        runs.append(np.mean(edges[1::2] - edges[::2]))
        want.append(1.0 / ((1 - params.lam_up[i]) * params.pi_up[i]))
    assert abs(np.mean(runs) / np.mean(want) - 1) < 0.1, (runs, want)


@pytest.mark.parametrize("kind", ["static", "markov"])
def test_clustered_channel_blocks_are_one_stream(kind):
    """tau_for_round equals trace to the bit across block refills."""
    per_round = _clustered_channel(kind, 0.8, seed=3, block=32)
    taus = [per_round.tau_for_round(r) for r in range(100)]
    bulk_u, bulk_d = _clustered_channel(kind, 0.8, seed=3, block=32).trace(0, 100)
    np.testing.assert_array_equal(np.array([t[0] for t in taus]), bulk_u)
    np.testing.assert_array_equal(np.array([t[1] for t in taus]), bulk_d)
    with pytest.raises(ValueError):
        per_round.tau_for_round(3)
    assert per_round.model_for_round(5) is CMODEL

"""The inputs the benchmark makes from the seed: its frozen copy of the
paper's link law and COPT-alpha against the port's own, and the data
streams that give both sides the same batches."""

import numpy as np
import pytest

from benchlib import data, links


def _links(registry, config):
    topology = registry.data("configs", config)["protocol"]["topology"]
    return registry.module("topologies", topology["kind"]).links(topology)


@pytest.fixture
def fig2b(registry):
    return _links(registry, "colrel-resnet20-cifar10")


def test_copt_alpha_equals_the_ports_and_is_unbiased(fig2b):
    from repro_torch.core import topology
    from repro_torch.core.weights import optimize_weights

    A = links.copt_alpha(fig2b, 30, 30)
    port = optimize_weights(topology.paper_fig2b(), sweeps=30, fine_tune_sweeps=30)
    np.testing.assert_allclose(A, port.A, rtol=0, atol=1e-12)
    np.testing.assert_allclose(links.unbiasedness_residual(fig2b, A), 0.0, atol=1e-9)
    assert links.variance_S(fig2b, A) == pytest.approx(port.S, rel=1e-12)


def test_the_launchers_links(registry):
    from repro_torch.core import topology
    from repro_torch.core.weights import optimize_weights

    lm = _links(registry, "colrel-olmo-1b-8l")
    port = topology.fully_connected(8, 0.3, p_c=0.8, rho=1.0)
    np.testing.assert_array_equal(lm.P, port.P)
    np.testing.assert_array_equal(lm.E, port.E)
    np.testing.assert_allclose(links.copt_alpha(lm, 20, 20),
                               optimize_weights(port, sweeps=20, fine_tune_sweeps=20).A, atol=1e-12)


def test_a_round_is_drawn_by_the_papers_law(fig2b):
    """The port's law (its own draws come in another order): the uplinks'
    and the links' marginals and the reciprocity, over many rounds."""
    from repro_torch.core.connectivity import LinkModel, sample_rounds

    R = 20000
    rng = np.random.default_rng(0)
    ours = [links.sample_round(fig2b, rng) for _ in range(R)]
    ups = np.stack([u for u, _ in ours])
    dds = np.stack([d for _, d in ours])
    p_ups, p_dds = sample_rounds(LinkModel(fig2b.p, fig2b.P, fig2b.E), np.random.default_rng(1), R)
    tol = 4 / np.sqrt(R)
    np.testing.assert_allclose(ups.mean(0), fig2b.p, atol=tol)
    np.testing.assert_allclose(dds.mean(0), fig2b.P, atol=tol)
    np.testing.assert_allclose(np.einsum("rij,rji->ij", dds, dds) / R, fig2b.E, atol=tol)
    np.testing.assert_allclose(ups.mean(0), p_ups.mean(0), atol=2 * tol)
    np.testing.assert_allclose(dds.mean(0), p_dds.mean(0), atol=2 * tol)


def test_taus_depend_on_the_seed_and_round_alone(fig2b):
    a, b = links.TauStream(fig2b, 2**31 + 9), links.TauStream(fig2b, 2**31 + 9)
    ups, dds = a.trace(4, 3)
    for i in range(3):
        u, d = b.tau_for_round(4 + i)
        np.testing.assert_array_equal(ups[i], u)
        np.testing.assert_array_equal(dds[i], d)
    assert np.all(np.diagonal(dds, axis1=1, axis2=2) == 1)


def test_the_static_law_gives_both_sides_the_same_taus(registry, fig2b):
    law = registry.module("channels", "static")
    program = law.program_channel(fig2b, 2**31 + 3)
    ups, dds = program.trace(0, 4)
    for r, (u, d) in enumerate(law.reference_taus(fig2b, 2**31 + 3, 4)):
        np.testing.assert_array_equal(ups[r], u)
        np.testing.assert_array_equal(dds[r], d)
    np.testing.assert_array_equal(program.model_for_round(0).p, fig2b.p)


def test_streams_repeat_for_the_same_seed():
    shard = {"x": np.arange(100)[:, None] * np.ones((1, 3)), "y": np.arange(100)}
    s1, s2 = data.ShardStream(shard, 8, 7, 0), data.ShardStream(shard, 8, 7, 0)
    other = data.ShardStream(shard, 8, 7, 1)
    b1 = s1.next_batches(4)
    np.testing.assert_array_equal(b1["y"], s2.next_batches(4)["y"])
    assert b1["x"].shape == (4, 8, 3)
    assert not np.array_equal(b1["y"], other.next_batches(4)["y"])


def test_sort_and_partition_is_the_papers(registry):
    from repro_torch.data.partition import partition_sort_and_partition

    labels = np.random.default_rng(0).integers(0, 10, 1000)
    ours = data.sort_and_partition(labels, 10, 3, np.random.default_rng(5))
    theirs = partition_sort_and_partition(labels, 10, 3, seed=5)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)

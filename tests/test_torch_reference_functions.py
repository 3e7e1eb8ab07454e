"""Public functions of the reference that the port copies: the token
dataset and the per-round batch stack (numpy, bitwise from the same seed),
the flat ravels (exact for f32 leaves; the concatenating ravel bitwise the
preallocated one), and the whole-trace Gilbert–Elliott sampler on the
device, held to the reference's host loop in law.

``sample_ge_rounds`` draws from a ``torch.Generator``, the host loop from
numpy, so the two are compared by their statistics: each uplink's and
D2D link's stationary marginal and joint ``E[tau_ij tau_ji]`` within 5
standard deviations of the link model (the deviations corrected for the
chains' autocorrelation, effective sample size ``(1 - lam) / (1 + lam)``),
as ``tests/test_torch_channel.py`` holds the channel; the uplinks' 1 -> 1
and 0 -> 1 transition rates of the device trace within 6 two-sample
binomial standard deviations of the host loop's; and reciprocity exactly:
the diagonal is 1, and on fully reciprocal links (``E = P``) every round's
``tau_dd`` is symmetric.
"""

import numpy as np
import pytest
import torch

from repro.channel import gilbert_elliott as jgilbert_elliott
from repro.channel import sample_ge_rounds_host as jsample_ge_rounds_host
from repro.core import flatten as jflatten
from repro.core import topology as jtopology
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro_torch.channel import gilbert_elliott, sample_ge_rounds
from repro_torch.core import flatten, topology
from repro_torch.data import (
    federated_batches,
    make_federated_clients,
    partition_iid,
    synthetic_tokens,
)

N = 6
R = 6000


@pytest.mark.parametrize("args", [(64, 17, 101, 0, 10), (5, 1, 7, 3, 2), (300, 33, 50000, 9, 4)])
def test_synthetic_tokens_bitwise(args):
    n, T, vocab, seed, styles = args
    got = synthetic_tokens(n, T, vocab, seed=seed, n_styles=styles)
    want = jsynthetic.synthetic_tokens(n, T, vocab, seed=seed, n_styles=styles)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_federated_batches_bitwise():
    toks, _ = synthetic_tokens(200, 9, 97, seed=1)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    parts = partition_iid(200, 5, seed=2)
    np.testing.assert_array_equal(np.concatenate(parts),
                                  np.concatenate(jpartition.partition_iid(200, 5, seed=2)))
    ours = make_federated_clients(arrays, parts, batch_size=4, seed=3)
    ref = jpipeline.make_federated_clients(arrays, parts, batch_size=4, seed=3)
    for _ in range(3):
        got, want = federated_batches(ours), jpipeline.federated_batches(ref)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (5, 4, 8)
            np.testing.assert_array_equal(got[k], want[k])


def _tree(rng, n=None, sizes=((3, 5), (13,), (2, 2, 2), (1,))):
    lead = () if n is None else (n,)
    return {f"w{i}": rng.normal(size=lead + s).astype(np.float32) for i, s in enumerate(sizes)}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_ravel_equals_the_reference(dtype):
    tree_np = _tree(np.random.default_rng(0))
    got = flatten.ravel({k: torch.from_numpy(v) for k, v in tree_np.items()},
                        dtype=getattr(torch, dtype) if dtype else None)
    want = np.asarray(jflatten.ravel(tree_np, dtype=dtype).astype(np.float32))
    assert got.shape == want.shape == (15 + 13 + 8 + 1,)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-7, rtol=0)
    single = flatten.ravel({"w": torch.from_numpy(tree_np["w1"])})
    np.testing.assert_array_equal(single.numpy(), tree_np["w1"])


# a tree whose d (15 + 13 + 2 + 1 = 31) is prime, and a single-leaf tree
@pytest.mark.parametrize("sizes", [((3, 5), (13,), (2,), (1,)), ((7, 11),)],
                         ids=["prime_d", "single_leaf"])
@pytest.mark.parametrize("leaf_dtype,cast", [(torch.float32, None),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, None),
                                             (torch.bfloat16, torch.float32)])
def test_ravel_stacked_concat_is_bitwise_ravel_stacked(sizes, leaf_dtype, cast):
    rng = np.random.default_rng(1)
    t = {k: torch.from_numpy(v).to(leaf_dtype) for k, v in _tree(rng, 4, sizes).items()}
    concat = flatten.ravel_stacked_concat(t, dtype=cast)
    mono = flatten.ravel_stacked(t, dtype=cast)
    assert concat.dtype == mono.dtype == (cast or leaf_dtype)
    assert torch.equal(concat, mono)
    assert torch.equal(torch.cat(flatten.ravel_stacked_segments(t, dtype=cast), 1), mono)
    ref = jflatten.ravel_stacked_concat({k: v.float().numpy() for k, v in t.items()},
                                        dtype=str(cast).removeprefix("torch.") if cast else None)
    np.testing.assert_array_equal(concat.float().numpy(), np.asarray(ref.astype(np.float32)))


MODEL = topology.fully_connected(N, 0.6, p_c=0.5, rho=0.5)
JMODEL = jtopology.fully_connected(N, 0.6, p_c=0.5, rho=0.5)
OFF = ~np.eye(N, dtype=bool)


def _rates(ups):
    """Per-chain 1 -> 1 and 0 -> 1 transition rates, pooled over uplinks,
    with the counts of their conditioning events."""
    prev, nxt = ups[:-1], ups[1:]
    on, off = prev == 1, prev == 0
    return (nxt[on].mean(), on.sum()), (nxt[off].mean(), off.sum())


@pytest.mark.parametrize("lam", [0.0, 0.8])
def test_sample_ge_rounds_has_the_host_loops_law(lam):
    params = gilbert_elliott(MODEL, memory=lam)
    ups_t, dds_t = sample_ge_rounds(params, torch.Generator().manual_seed(0), R)
    assert ups_t.shape == (R, N) and dds_t.shape == (R, N, N)
    assert ups_t.dtype == dds_t.dtype == torch.float32 and ups_t.device.type == "cpu"
    ups, dds = ups_t.double().numpy(), dds_t.double().numpy()
    ess = (1 - lam) / (1 + lam)
    tol_up = 5 * np.sqrt(MODEL.p * (1 - MODEL.p) / (R * ess))
    assert np.all(np.abs(ups.mean(0) - MODEL.p) < tol_up)
    tol_dd = 5 * np.sqrt(np.maximum(MODEL.P * (1 - MODEL.P), 1e-12) / (R * ess))
    assert np.all((np.abs(dds.mean(0) - MODEL.P) < tol_dd)[OFF])
    joint = (dds * np.swapaxes(dds, 1, 2)).mean(0)
    tol_e = 5 * np.sqrt(np.maximum(MODEL.E * (1 - MODEL.E), 1e-12) / (R * ess))
    assert np.all((np.abs(joint - MODEL.E) < tol_e)[OFF])
    assert np.all(dds[:, np.arange(N), np.arange(N)] == 1.0)

    h_ups, _ = jsample_ge_rounds_host(jgilbert_elliott(JMODEL, memory=lam),
                                      np.random.default_rng(0), R)
    for (got, n_got), (want, n_want) in zip(_rates(ups), _rates(h_ups)):
        p = (got * n_got + want * n_want) / (n_got + n_want)
        sd = np.sqrt(p * (1 - p) * (1 / n_got + 1 / n_want))
        assert abs(got - want) < 6 * sd, (lam, got, want, sd)


def test_sample_ge_rounds_is_reciprocal_on_reciprocal_links():
    model = topology.fully_connected(N, 0.6, p_c=0.5, rho=1.0)
    assert np.array_equal(model.E, model.P)
    _, dds = sample_ge_rounds(gilbert_elliott(model, memory=0.7),
                              torch.Generator().manual_seed(1), 500)
    assert torch.equal(dds, dds.transpose(1, 2))
    assert 0.0 < float(dds.mean()) < 1.0


def test_sample_ge_rounds_repeats_from_one_seed():
    params = gilbert_elliott(MODEL, memory=0.5)
    a = sample_ge_rounds(params, torch.Generator().manual_seed(5), 64)
    b = sample_ge_rounds(params, torch.Generator().manual_seed(5), 64)
    assert all(torch.equal(x, y) for x, y in zip(a, b))

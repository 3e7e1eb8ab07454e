"""The sparsifying wire codecs (``topk``, ``randk``) against the reference,
on the CPU, after ``tests/test_wire.py``.

* The descriptors are the reference's exactly (bits, gain, variance).
* ``topk`` keeps the reference's support and values on continuous random
  data (no ties in ``|x|``), bitwise.
* ``randk`` draws from a ``torch.Generator`` (the reference from
  ``jax.random``), so it is held by its law, as the reference test holds
  its own: exactly k coordinates a row, kept values untouched, and the
  gain-corrected mean over 4000 draws within 5 sigma of x.
* A ``quantized(codec="topk")`` run of the quadratic task tracks the
  reference's at ``tests/test_torch_slice.py``'s tolerances; a ``topk``
  or ``randk`` chunk is bitwise its per-round run, the codec's generator
  included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import wire as jwire
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro_torch import strategies, tree, wire
from repro_torch.convert import params_from_jax
from repro_torch.fl.experiment import ExperimentSpec, build_experiment
from test_torch_slice import SPECS

ROUNDS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stack(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


CODEC_OPTIONS = [dict(k=7), dict(fraction=0.1), dict(fraction=0.25), dict(fraction=1.0),
                 dict(k=10_000), dict(fraction=1e-9)]


@pytest.mark.parametrize("name", ["topk", "randk"])
@pytest.mark.parametrize("options", CODEC_OPTIONS, ids=str)
def test_descriptor_equals_reference(name, options):
    ours, theirs = wire.get(name, **options), jwire.get(name, **options)
    for d in (1, 2, 7, 40, 4099, 272282):
        assert dataclasses.asdict(ours.descriptor(d)) == dataclasses.asdict(theirs.descriptor(d))
        assert ours._k(d) == theirs._k(d)
    assert ours.stateful == theirs.stateful
    assert not ours.supports_fused_dequant and not ours.supports_segmented


@pytest.mark.parametrize("n,d,options", [(5, 40, dict(k=7)), (10, 1000, dict(fraction=0.1)),
                                         (3, 33, dict(fraction=0.25)), (4, 9, dict(k=9)),
                                         (1, 17, dict(k=1))])
def test_topk_equals_reference(n, d, options):
    x = _stack(n, d, seed=n + d)
    ours, theirs = wire.get("topk", **options), jwire.get("topk", **options)
    enc, state = ours.encode(torch.from_numpy(x), ())
    jenc, _ = theirs.encode(jnp.asarray(x), ())
    assert state == () and enc.dtype == torch.float32
    np.testing.assert_array_equal(ours.decode(enc).numpy(), np.asarray(theirs.decode(jenc)))
    k = ours._k(d)
    for i in range(n):
        support = np.flatnonzero(enc[i].numpy())
        assert set(support) == set(np.argsort(-np.abs(x[i]))[:k])
        np.testing.assert_array_equal(enc[i].numpy()[support], x[i][support])


def test_randk_unbiased_after_gain_correction():
    x = torch.from_numpy(_stack(3, 32, seed=0))
    codec = wire.get("randk", fraction=0.25)
    desc = codec.descriptor(32)
    assert desc.gain == pytest.approx(8 / 32) and desc.unbiased
    state = codec.init_state(3, 32)
    draws = 4000
    acc = torch.zeros_like(x)
    for _ in range(draws):
        enc, state = codec.encode(x, state)
        assert (torch.count_nonzero(enc, dim=1) == 8).all()
        kept = enc != 0
        assert torch.equal(enc[kept], x[kept])
        acc += codec.decode(enc)
    corrected = acc.numpy() / draws / desc.gain
    # per-coordinate variance after correction is (d/k - 1) x^2
    sigma = np.abs(x.numpy()) * np.sqrt(desc.rel_variance / draws)
    np.testing.assert_array_less(np.abs(corrected - x.numpy()), 5.0 * sigma + 1e-6)


def test_randk_state_is_explicit_and_advances():
    x = torch.from_numpy(_stack(4, 64, seed=1))
    codec = wire.get("randk", fraction=0.1, seed=3)
    s1, s2 = codec.init_state(4, 64), codec.init_state(4, 64)
    e1, n1 = codec.encode(x, s1)
    e2, _ = codec.encode(x, s2)
    assert n1 is s1 and torch.equal(e1, e2)  # the same seed, the same draws
    e3, _ = codec.encode(x, n1)
    assert not torch.equal(e1, e3)  # and the state advanced


# -- the sparsifying codecs through quantized relaying --------------------------------

@pytest.fixture(scope="module")
def topk_reference():
    cache = {}

    def get(model):
        if model not in cache:
            exp = jbuild_experiment(JExperimentSpec(**SPECS[model], strategy="quantized",
                                                    strategy_options=TOPK))
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(ROUNDS)
            cache[model] = (init, exp.log, jax.tree.map(np.array, exp.trainer.params))
        return cache[model]

    return get


TOPK = {"codec": "topk", "codec_options": {"fraction": 0.1}}


# The quadratic task only: its 16 coordinates a client are far apart in
# magnitude.  On cifar_cnn a last-bit difference between the packages'
# updates flips a coordinate at the k-th largest magnitude in or out of the
# support (one of 576 in a leaf after two rounds, 6.7e-6 apart), which no
# tolerance of the slice admits; topk itself is held bitwise above.
@pytest.mark.parametrize("model", ["quadratic"])
def test_topk_quantized_tracks_reference(topk_reference, model):
    init, jlog, jfinal = topk_reference(model)
    exp = build_experiment(ExperimentSpec(**SPECS[model], strategy="quantized",
                                          strategy_options=TOPK), device="cpu")
    exp.trainer.params = params_from_jax(init, "cpu")
    log = exp.run(ROUNDS)
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    d = sum(x.numel() for x in tree.leaves(exp.params))
    bits = wire.get("topk", fraction=0.1).descriptor(d).bits_per_coord
    # the round's f32 product of the participation and the descriptor's bits
    assert log.uplink_bits == [float(np.float32(p) * np.float32(d * bits))
                               for p in log.participation]
    assert np.isnan(log.weight_sums).all() and np.isnan(jlog.weight_sums).all()
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    for got, want in zip(tree.leaves(exp.params), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("inner", [{}, {"inner": "multihop", "inner_options": {"hops": 2}}],
                         ids=["colrel", "multihop"])
@pytest.mark.parametrize("codec", ["topk", "randk"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_sparse_quantized_chunk_equals_per_round(model, codec, inner):
    opts = {"codec": codec, "codec_options": {"fraction": 0.25}, **inner}
    spec = ExperimentSpec(**SPECS[model], strategy="quantized", strategy_options=opts)
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(6)
    b.run(6, chunk=3)
    for field in ("loss", "participation", "uplink_bits"):
        assert getattr(a.log, field) == getattr(b.log, field), field
    for state in ("params", "server_state", "agg_state"):
        for x, y in zip(tree.leaves(getattr(a.trainer, state)),
                        tree.leaves(getattr(b.trainer, state))):
            if isinstance(x, torch.Generator):
                assert torch.equal(x.get_state(), y.get_state())
            else:
                assert torch.equal(x, y), state
    if inner:
        assert a.strategy.inner.correction is not None  # calibrated through quantized


def test_sparse_codecs_refuse_the_dequant_kernel():
    for name in ("topk", "randk"):
        with pytest.raises(ValueError, match="supports_fused_dequant"):
            strategies.get("quantized", codec=name, fused="kernel")

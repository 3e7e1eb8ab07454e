"""The port's wire codecs, quantized strategy and the dequant kernel's plain
version against the reference.

* The int8 row scale is computed by the same f32 operations in both
  packages and is held bitwise; so is ``decode`` on identical ``q``.
* The rounding noise comes from another generator (the reference's is a
  ``jax.random`` key), so the port's int8 codec is held by its law, as
  ``tests/test_wire.py`` holds the reference: every coordinate moves at
  most one grid pitch, and the mean over 1500 draws lies within 5 sigma
  of x.
* ``encode_segments``' row scale equals ``encode``'s bitwise (max is exact).
* The plain ``fused_dequant_aggregate`` against
  ``fused_dequant_aggregate_pallas(interpret=True)`` on identical int8
  ``q`` and scales: atol 1e-5 (f32 sums in another order).
* ``quantized(codec="identity")`` is bitwise the port's colrel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import wire as jwire
from repro.kernels.fused_dequant import fused_dequant_aggregate_pallas
from repro_torch import strategies, tree, wire
from repro_torch.kernels import fused_dequant as fdq
from repro_torch.kernels import ops
from repro_torch.strategies.base import ExecutionContext

ATOL = 1e-5


def _stack(n=6, d=128, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    x[0, :] = 0.0  # an all-zero row takes the scale floor
    return x


def _taus(n, seed):
    rng = np.random.default_rng(seed)
    tu = (rng.random(n) < 0.7).astype(np.float32)
    td = (rng.random((n, n)) < 0.6).astype(np.float32)
    A = (np.abs(rng.normal(size=(n, n))) + np.eye(n)).astype(np.float32)
    return tu, td, A


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_int8_scale_equals_the_reference(bits):
    x = _stack(seed=bits)
    jcodec = jwire.get("int8", bits=bits)
    (_, jscale), _ = jcodec.encode(jnp.asarray(x), jcodec.init_state(6, 128))
    codec = wire.get("int8", bits=bits)
    (q, scale), _ = codec.encode(torch.from_numpy(x), codec.init_state(6, 128))
    assert q.dtype == torch.int8 and scale.shape == (6, 1)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_decode_equals_the_reference_on_identical_q():
    x = _stack(seed=1)
    jcodec = jwire.get("int8")
    (jq, jscale), _ = jcodec.encode(jnp.asarray(x), jcodec.init_state(6, 128))
    got = wire.get("int8").decode((torch.from_numpy(np.array(jq)),
                                   torch.from_numpy(np.array(jscale))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcodec.decode((jq, jscale))))


def test_int8_roundtrip_bounded_by_grid_pitch():
    x = torch.from_numpy(_stack(seed=2))
    codec = wire.get("int8")
    (q, scale), _ = codec.encode(x, codec.init_state(*x.shape))
    err = (codec.decode((q, scale)) - x).abs()
    assert bool(torch.all(err < scale.expand_as(err) + 1e-9))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_int8_stochastic_rounding_unbiased(bits):
    x = torch.from_numpy(_stack(n=4, d=64, seed=3))
    codec = wire.get("int8", bits=bits)
    state = codec.init_state(4, 64)
    draws = 1500
    acc = torch.zeros_like(x)
    for _ in range(draws):
        enc, state = codec.encode(x, state)
        acc += codec.decode(enc)
    pitch = torch.amax(x.abs(), dim=1, keepdim=True) / codec.levels
    err = (acc / draws - x).abs()
    assert bool(torch.all(err < 5.0 * pitch / np.sqrt(draws) + 1e-7))


def test_int8_state_is_explicit_and_advances():
    x = torch.from_numpy(_stack(seed=4))
    codec = wire.get("int8", seed=5)
    st = codec.init_state(*x.shape)
    assert st == (5, 0)
    (q1, _), nxt = codec.encode(x, st)
    (q2, _), _ = codec.encode(x, st)
    assert torch.equal(q1, q2) and nxt == (5, 1)
    (q3, _), _ = codec.encode(x, nxt)
    assert not torch.equal(q1, q3)


def test_encode_segments_scale_is_the_monolithic_scale():
    x = torch.from_numpy(_stack(n=5, d=300, seed=6))
    codec = wire.get("int8")
    st = codec.init_state(5, 300)
    (_, scale), nxt = codec.encode(x, st)
    cuts = [0, 7, 128, 129, 300]
    (qs, seg_scale), seg_nxt = codec.encode_segments(
        [x[:, a:b].contiguous() for a, b in zip(cuts, cuts[1:])], st)
    assert torch.equal(seg_scale, scale) and seg_nxt == nxt
    assert [tuple(q.shape) for q in qs] == [(5, b - a) for a, b in zip(cuts, cuts[1:])]
    recon = codec.decode((torch.cat(qs, dim=1), seg_scale))
    err = (recon - x).abs()
    assert bool(torch.all(err < scale.expand_as(err) + 1e-9))


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 96, 1000, 2500])
def test_fused_dequant_plain_matches_pallas(n, d):
    x = _stack(n=n, d=d, seed=n + d)
    tu, td, A = _taus(n, seed=n * d)
    jcodec = jwire.get("int8")
    (jq, jscale), _ = jcodec.encode(jnp.asarray(x), jcodec.init_state(n, d))
    want = fused_dequant_aggregate_pallas(jnp.asarray(A), jnp.asarray(tu), jnp.asarray(td),
                                          jq, jscale, block_d=2048, interpret=True)
    q, scale = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jscale))
    got = fdq.fused_dequant_aggregate_plain(torch.from_numpy(A), torch.from_numpy(tu),
                                            torch.from_numpy(td), q, scale)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the segment path: fold once, stream int8 columns, bitwise the monolithic pass
    ws = ops.fold_dequant_scales(ops.collapsed_weight_row(*map(torch.from_numpy, (A, tu, td))),
                                 scale)
    cuts = sorted({0, min(d, 17), d})
    parts = [ops.dequant_row_stream(ws, q[:, a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), got)


def test_quantized_identity_is_bitwise_colrel():
    x = torch.from_numpy(_stack(n=8, d=300, seed=7))
    tu, td, A = map(torch.from_numpy, _taus(8, seed=8))
    qs = strategies.get("quantized", codec="identity")
    dq, _ = qs.aggregate(x, tu, td, A, qs.init_state(8, 300))
    dc, _ = strategies.get("colrel").aggregate(x, tu, td, A, ())
    assert torch.equal(dq, dc)


def _deltas(n, seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (16, 32), "b": (8,), "c": (3, 3)}
    return {k: torch.from_numpy(rng.normal(size=(n,) + s).astype(np.float32))
            for k, s in shapes.items()}


def test_quantized_kernel_path_matches_the_dequant_oracle():
    """Monolithic kernel path vs ``fused=False`` on the same codec state:
    the same q, summed in another order (atol 1e-5); the segment path draws
    another realization but keeps the scale and advances the state alike."""
    n = 8
    deltas = _deltas(n, seed=9)
    tu, td, A = map(torch.from_numpy, _taus(n, seed=10))
    ctx = ExecutionContext(n_clients=n)
    kernel = strategies.get("quantized", codec="int8", fused="kernel")
    oracle = strategies.get("quantized", codec="int8")
    st = kernel.init_state(n, 16 * 32 + 8 + 9)
    gk, stk = kernel.aggregate_tree(deltas, tu, td, A, st, ctx)
    go, sto = oracle.aggregate_tree(deltas, tu, td, A, st, ctx)
    assert stk == sto == ((0, 1), ())
    for a, b in zip(tree.leaves(gk), tree.leaves(go)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    gs, sts = kernel.aggregate_tree(deltas, tu, td, A, st, ExecutionContext(n_clients=n,
                                                                           segment_d=1))
    assert sts == stk
    for a, b in zip(tree.leaves(gs), tree.leaves(go)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())


def test_quantized_options_and_registry():
    q = strategies.get("quantized")
    assert q.codec.name == "int8" and q.inner.name == "colrel" and q.needs_A
    assert q.wire_bits_per_coord(64) == 8 + 32 / 64
    assert not strategies.get("quantized", inner="fedavg_blind").needs_A
    with pytest.raises(ValueError, match="do not nest"):
        strategies.get("quantized", inner="quantized")
    with pytest.raises(ValueError, match="supports_fused_dequant"):
        strategies.get("quantized", codec="identity", fused="kernel")
    with pytest.raises(ValueError, match="colrel"):
        strategies.get("quantized", inner="fedavg_blind", fused="kernel")
    with pytest.raises(ValueError, match="bits"):
        wire.get("int8", bits=9)
    assert {"identity", "int8"} <= set(wire.available())
    with pytest.raises(KeyError, match="unknown wire codec"):
        wire.get("does_not_exist")
    with pytest.raises(ValueError, match="already registered"):
        wire.register("int8", wire.Int8StochasticCodec)
    for name in ("topk", "randk"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 11"):
            strategies.get("quantized", codec=name)


def test_custom_codec_gain_is_divided_out():
    @wire.register("negate", overwrite=True)
    class NegateCodec(wire.WireCodec):
        name = "negate"

        def descriptor(self, d):
            return wire.CodecDescriptor(name="negate", bits_per_coord=32.0, unbiased=True,
                                        gain=-1.0)

        def encode(self, x, state):
            return -x, state

        def decode(self, encoded):
            return encoded

    s = strategies.get("quantized", codec="negate", inner="fedavg_perfect")
    x = torch.from_numpy(_stack(seed=11))
    tu, td, A = map(torch.from_numpy, _taus(6, seed=12))
    delta, _ = s.aggregate(x, tu, td, A, s.init_state(*x.shape))
    torch.testing.assert_close(delta, x.mean(dim=0), rtol=1e-6, atol=0)

"""The port's aggregation kernels (plain PyTorch versions, the CPU path)
against the reference's Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed and handed to both.  Both sides
widen bf16/int8 to f32 exactly and accumulate in f32, so they differ only
in summation order: atol 1e-5 (the bar ``tests/test_fused_aggregate.py``
holds the Pallas kernel to) for every dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_aggregate import fused_aggregate_pallas, row_stream_pallas
from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels import ops

ATOL = 1e-5


def _round_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) * 0.5 + 0.1).astype(np.float32)
    tau_up = (rng.random(n) < 0.7).astype(np.float32)
    tau_dd = (rng.random((n, n)) < 0.5).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    return A, tau_up, tau_dd, X


# int8 stacks are X quantized at a scale of 1/40; the callers fold that
# dequant scale into the weight row, which keeps outputs at unit scale
INT8_SCALE = 1.0 / 40


def _stack(X, dtype):
    """The same values as a jax and a torch array of ``dtype``."""
    if dtype == "int8":
        q = np.clip(np.round(X / INT8_SCALE), -127, 127).astype(np.int8)
        return jnp.asarray(q), torch.from_numpy(q)
    if dtype == "bfloat16":
        xj = jnp.asarray(X).astype(jnp.bfloat16)
        return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(X), torch.from_numpy(X)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 300, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_aggregate_plain_matches_pallas(n, d, dtype):
    A, tau_up, tau_dd, X = _round_inputs(n, d, seed=n * 7 + d)
    xj, xt = _stack(X, dtype)
    want = fused_aggregate_pallas(jnp.asarray(A), jnp.asarray(tau_up), jnp.asarray(tau_dd),
                                  xj, block_d=2048, interpret=True)
    got = fa.fused_aggregate_plain(torch.from_numpy(A), torch.from_numpy(tau_up),
                                   torch.from_numpy(tau_dd), xt)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 300, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_row_stream_plain_matches_pallas(n, d, dtype):
    A, tau_up, tau_dd, X = _round_inputs(n, d, seed=n * 11 + d)
    w = tau_up @ (A * tau_dd.T) / n
    if dtype == "int8":
        w = w * INT8_SCALE
    w = w.astype(np.float32)
    xj, xt = _stack(X, dtype)
    want = row_stream_pallas(jnp.asarray(w), xj, block_d=2048, interpret=True)
    got = fa.row_stream_plain(torch.from_numpy(w), xt)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_collapsed_weight_row_matches_reference_expression():
    A, tau_up, tau_dd, _ = _round_inputs(10, 1, seed=3)
    got = ops.collapsed_weight_row(torch.from_numpy(A), torch.from_numpy(tau_up),
                                   torch.from_numpy(tau_dd))
    want = (tau_up.astype(np.float64) @ (A * tau_dd.T)) / 10
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_ops_dispatch_cpu_takes_plain_version_without_launching():
    A, tau_up, tau_dd, X = _round_inputs(10, 300, seed=5)
    args = [torch.from_numpy(a) for a in (A, tau_up, tau_dd, X)]
    before = (fa.fused_aggregate_cuda.launches, fa.row_stream_cuda.launches)
    fa.fused_aggregate_cuda.launches = fa.row_stream_cuda.launches = 0
    try:
        got = ops.fused_aggregate(*args)
        assert torch.equal(got, fa.fused_aggregate_plain(*args))
        w = ops.collapsed_weight_row(*args[:3])
        assert torch.equal(ops.row_stream(w, args[3]), fa.row_stream_plain(w, args[3]))
        assert (fa.fused_aggregate_cuda.launches, fa.row_stream_cuda.launches) == (0, 0)
    finally:
        fa.fused_aggregate_cuda.launches, fa.row_stream_cuda.launches = before


def test_cuda_wrappers_refuse_cpu_tensors():
    A, tau_up, tau_dd, X = _round_inputs(4, 16, seed=1)
    args = [torch.from_numpy(a) for a in (A, tau_up, tau_dd, X)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.fused_aggregate_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.row_stream_cuda(args[1], args[3])


def test_segments_equal_monolithic_bitwise():
    """Per-segment row streams give exactly the columns of the one-pass
    aggregate (the plain versions run the kernels' arithmetic)."""
    A, tau_up, tau_dd, X = _round_inputs(10, 1000, seed=9)
    args = [torch.from_numpy(a) for a in (A, tau_up, tau_dd, X)]
    mono = ops.fused_aggregate(*args)
    w = ops.collapsed_weight_row(*args[:3])
    cuts = [0, 10, 11, 400, 1000]
    parts = [ops.row_stream(w, args[3][:, a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), mono)

"""Kernel 11 (the chunked SSD recurrence) and the SSD half of
``models/ssm.py`` in the port against a live run of the reference, on the
CPU.

The same numpy inputs (from a seed) go through both packages.
Tolerances:

* ``ssd_scan_plain`` against ``ssd_scan_pallas(..., interpret=True)``:
  atol = rtol = 5e-4 in f32, the reference's bound for its own kernel
  (``tests/test_kernels.py:96``); measured ~3e-5 at |y| ~ 30, the
  matmuls summing in another order.  bf16 inputs: atol = rtol = 2e-2,
  compared in f32; both sides compute in f32 (the Pallas kernel widens v
  to f32 before its PV product, so its cast of the weighted scores to
  v's dtype is to f32) and round the output to bf16 once, so they differ
  by at most one bf16 ulp of the output.
* The port's ``ssd_chunked``, ``ssd_step`` and ``ssd_reference`` against
  the reference's: 1e-5 relative to max(1, max|want|), f32 on both sides.
* ``ops.ssd_scan`` against ``ssd_chunked`` at zero state, as
  ``tests/test_kernels.py:99-116`` holds the Pallas kernel: 5e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm

KERNEL_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
TOL = 1e-5
SHAPES = [(2, 128, 8, 16), (1, 64, 4, 4), (3, 96, 16, 32)]  # the reference test's (BH, T, Dk, Dv)


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


def _scan_inputs(shape, seed):
    BH, T, Dk, Dv = shape
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(BH, T, Dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(BH, T, Dv)).astype(np.float32)
    logd = -np.abs(rng.normal(size=(BH, T))).astype(np.float32)
    return q, k, v, logd


def _mixer_inputs(B, T, H, Dk, Dv, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, T, H, Dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, T, H, Dv)).astype(np.float32)
    loga = -np.abs(rng.normal(size=(B, T, H))).astype(np.float32)
    return q, k, v, loga


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_plain_matches_pallas_kernel(shape, chunk, dtype):
    q, k, v, logd = _scan_inputs(shape, seed=sum(shape) + chunk)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = ssd_scan_pallas(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(logd),
                           chunk=chunk, interpret=True)
    got = ssd.ssd_scan_plain(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                             torch.from_numpy(logd), chunk=chunk)
    assert got.shape == want.shape and got.dtype == dtype
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(2, 128, 16, 64), (1, 64, 16, 64), (2, 128, 32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_plain_matches_pallas_kernel_at_the_prefill_class(shape, dtype):
    """The jamba prefill's per-slice class (Dk 16, Dv 64, chunk 64), which
    ``SHAPES`` never reach, at small BH and T: two chunks, one chunk, and
    the widest key dim the kernel takes."""
    q, k, v, logd = _scan_inputs(shape, seed=sum(shape))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = ssd_scan_pallas(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(logd),
                           chunk=64, interpret=True)
    got = ssd.ssd_scan_plain(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                             torch.from_numpy(logd), chunk=64)
    assert got.shape == want.shape and got.dtype == dtype
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_scan_plain_matches_reference_oracle(shape):
    """Against ``kernels/ref.py:ssd_scan_ref``, the oracle the reference
    holds its kernel to, with the chunk the whole sequence."""
    q, k, v, logd = _scan_inputs(shape, seed=7 * sum(shape))
    want = jref.ssd_scan_ref(*(jnp.asarray(x) for x in (q, k, v, logd)))
    got = ssd.ssd_scan_plain(*(torch.from_numpy(x) for x in (q, k, v, logd)), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_reference(with_state, chunk):
    B, T, H, Dk, Dv = 2, 64, 3, 8, 8
    q, k, v, loga = _mixer_inputs(B, T, H, Dk, Dv, seed=chunk + with_state)
    state = np.random.default_rng(3).normal(size=(B, H, Dk, Dv)).astype(np.float32)
    s_j = jnp.asarray(state) if with_state else None
    s_t = torch.from_numpy(state) if with_state else None
    y_want, S_want = jssm.ssd_chunked(*(jnp.asarray(x) for x in (q, k, v, loga)), state=s_j,
                                      chunk=chunk)
    y_got, S_got = ssm.ssd_chunked(*(torch.from_numpy(x) for x in (q, k, v, loga)), state=s_t,
                                   chunk=chunk)
    _close(y_got, y_want, TOL)
    _close(S_got, S_want, TOL)
    assert S_got.dtype == torch.float32


def test_ssd_step_and_reference_match_reference():
    B, T, H, Dk, Dv = 2, 24, 3, 4, 8
    q, k, v, loga = _mixer_inputs(B, T, H, Dk, Dv, seed=11)
    state = np.random.default_rng(5).normal(size=(B, H, Dk, Dv)).astype(np.float32)
    y_want, S_want = jssm.ssd_step(*(jnp.asarray(x[:, 0]) for x in (q, k, v, loga)),
                                   jnp.asarray(state))
    y_got, S_got = ssm.ssd_step(*(torch.from_numpy(x[:, 0]) for x in (q, k, v, loga)),
                                torch.from_numpy(state))
    _close(y_got, y_want, TOL)
    _close(S_got, S_want, TOL)
    y_want, S_want = jssm.ssd_reference(*(jnp.asarray(x) for x in (q, k, v, loga)),
                                        state=jnp.asarray(state))
    y_got, S_got = ssm.ssd_reference(*(torch.from_numpy(x) for x in (q, k, v, loga)),
                                     state=torch.from_numpy(state))
    _close(y_got, y_want, TOL)
    _close(S_got, S_want, TOL)


def test_ssd_chunked_equals_the_sequential_recurrence():
    """Within the port: the chunked form and the token loop, from a given
    state, at 1e-5."""
    B, T, H, Dk, Dv = 1, 48, 2, 16, 8
    q, k, v, loga = (torch.from_numpy(x) for x in _mixer_inputs(B, T, H, Dk, Dv, seed=2))
    S0 = torch.randn(B, H, Dk, Dv, generator=torch.Generator().manual_seed(0))
    y_c, S_c = ssm.ssd_chunked(q, k, v, loga, state=S0, chunk=16)
    y_r, S_r = ssm.ssd_reference(q, k, v, loga, state=S0)
    torch.testing.assert_close(y_c, y_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S_c, S_r, atol=1e-4, rtol=1e-4)


def test_ops_ssd_scan_matches_chunked_at_zero_state():
    """``tests/test_kernels.py:99-116`` for the port: the (B*H, T, .) layout
    through ``ops.ssd_scan`` against the production ``ssd_chunked``, and
    the same operands as (B, H, T, .) strided views (the Mamba mixer's
    call) giving the same result."""
    B, T, H, Dk, Dv = 2, 64, 3, 8, 8
    q, k, v, loga = (torch.from_numpy(x) for x in _mixer_inputs(B, T, H, Dk, Dv, seed=13))
    y_chunked, _ = ssm.ssd_chunked(q, k, v, loga, chunk=16)

    def flat(x):
        return x.transpose(1, 2).reshape(B * H, T, *x.shape[3:])

    y_k = ops.ssd_scan(flat(q), flat(k), flat(v), loga.transpose(1, 2).reshape(B * H, T),
                       chunk=16)
    y_k = y_k.reshape(B, H, T, Dv).transpose(1, 2)
    np.testing.assert_allclose(y_k.numpy(), y_chunked.numpy(), atol=5e-4, rtol=5e-4)
    y_v = ops.ssd_scan(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                       loga.permute(0, 2, 1), chunk=16).permute(0, 2, 1, 3)
    torch.testing.assert_close(y_v, y_k, atol=0.0, rtol=0.0)
    # the reference kernel on the same flat operands
    want = ssd_scan_pallas(*(jnp.asarray(flat(x).numpy()) for x in (q, k, v)),
                           jnp.asarray(loga.transpose(1, 2).reshape(B * H, T).numpy()), chunk=16,
                           interpret=True)
    np.testing.assert_allclose(y_k.transpose(1, 2).reshape(B * H, T, Dv).numpy(),
                               np.asarray(want), atol=5e-4, rtol=5e-4)


def test_ops_ssd_scan_keeps_the_reference_chunk_rule():
    q = torch.randn(2, 48, 4)
    v = torch.randn(2, 48, 8)
    logd = -torch.rand(2, 48)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ops.ssd_scan(q, q, v, logd, chunk=32)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssd.ssd_scan_plain(q, q, v, logd, chunk=32)
    assert ops.ssd_scan(q, q, v, logd, chunk=16).shape == (2, 48, 8)


def test_ssd_scan_wrapper_takes_cuda_tensors_only():
    """On the CPU the dispatch takes the plain version; the kernel's
    wrapper itself refuses a CPU tensor rather than computing on it."""
    q = torch.randn(2, 64, 4)
    before = ssd.ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(q, q, torch.randn(2, 64, 8), -torch.rand(2, 64), chunk=16)
    assert ssd.ssd_scan_cuda.launches == before

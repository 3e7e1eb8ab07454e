"""Kernel 10, causal flash attention: the port's plain version and its
``ops.flash_attention`` entry point against the reference's Pallas kernel
(run in interpret mode, as ``tests/test_kernels.py`` runs it) and its jnp
oracle ``ref.flash_attention_ref``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own for its kernel
(``tests/test_kernels.py:52``): atol = rtol = 2e-5 in f32 (both sides
compute in f32, the Pallas kernel with an online softmax), 2e-2 in bf16
(outputs rounded to bf16 on both sides), compared in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _pair(arrays, dtype):
    """The same numpy inputs as reference arrays and port tensors, both
    rounded to ``dtype``."""
    j = [jnp.asarray(a).astype(JDTYPE[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _assert_close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# the reference's sweep (tests/test_kernels.py:47), as (BH, T, D)
SWEEP = [(1, 128, 2, 64), (2, 256, 4, 32), (1, 192, 1, 128)]


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_oracle(shape, dtype):
    B, T, H, D = shape
    (jq, jk, jv), (q, k, v) = _pair(_qkv((B * H, T, D), seed=T + D), dtype)
    got = fl.flash_attention_plain(q, k, v)
    assert got.shape == (B * H, T, D) and got.dtype == q.dtype
    _assert_close(got, flash_attention_pallas(jq, jk, jv, block_q=64, block_kv=64,
                                              interpret=True), dtype)
    _assert_close(got, jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention_matches_reference_entry_point(shape, dtype):
    """(B, T, H, D) in and out, through the layout change of both
    packages' ``ops.flash_attention``."""
    (jq, jk, jv), (q, k, v) = _pair(_qkv(shape, seed=sum(shape)), dtype)
    before = fl.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, block_q=64, block_kv=64)
    assert fl.flash_attention_cuda.launches == before  # CPU tensors take the plain version
    assert got.shape == shape and got.dtype == q.dtype
    _assert_close(got, jops.flash_attention(jq, jk, jv, block_q=64, block_kv=64), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_wrapper_matches_reference(dtype):
    """Grouped kv heads (H=4 over KV=2, and H=16 over KV=8) broadcast to
    the query heads as the reference's ``jnp.repeat`` does."""
    for B, T, H, KV, D in ((2, 128, 4, 2, 32), (1, 128, 16, 8, 64)):
        rng = np.random.default_rng(H)
        arrays = [rng.normal(size=(B, T, n, D)).astype(np.float32) for n in (H, KV, KV)]
        (jq, jk, jv), (q, k, v) = _pair(arrays, dtype)
        got = ops.flash_attention(q, k, v, block_q=64, block_kv=64)
        _assert_close(got, jops.flash_attention(jq, jk, jv, block_q=64, block_kv=64), dtype)
        G = H // KV
        kr = jnp.repeat(jk, G, 2).transpose(0, 2, 1, 3).reshape(B * H, T, D)
        vr = jnp.repeat(jv, G, 2).transpose(0, 2, 1, 3).reshape(B * H, T, D)
        qr = jq.transpose(0, 2, 1, 3).reshape(B * H, T, D)
        want = jref.flash_attention_ref(qr, kr, vr).reshape(B, H, T, D).transpose(0, 2, 1, 3)
        _assert_close(got, want, dtype)


def test_wrapper_raises_where_the_reference_asserts():
    """T=192 is not a whole number of 128-row blocks: the reference
    kernel's assert, the port's ValueError."""
    (jq, jk, jv), (q, k, v) = _pair(_qkv((1, 192, 2, 64), seed=3), "float32")
    with pytest.raises(AssertionError):
        jops.flash_attention(jq, jk, jv, block_q=128, block_kv=128)
    with pytest.raises(ValueError, match="whole number of blocks"):
        ops.flash_attention(q, k, v, block_q=128, block_kv=128)
    # the reference's min(block, T): T=96 < 128 is one block on both sides
    (jq, jk, jv), (q, k, v) = _pair(_qkv((1, 96, 2, 32), seed=4), "float32")
    _assert_close(ops.flash_attention(q, k, v), jops.flash_attention(jq, jk, jv), "float32")
    with pytest.raises(ValueError, match="only causal"):
        ops.flash_attention(q, k, v, causal=False)


def test_non_cpu_tensors_go_to_the_kernel_and_never_fall_back():
    """A tensor that is not on the CPU takes the kernel path: without a
    CUDA tensor the kernel wrapper raises; the plain version is never
    taken instead."""
    q = torch.zeros((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, q, q)
    cpu = torch.zeros((2, 128, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_cuda(cpu, cpu, cpu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_jamba_head_ratio_matches_reference_entry_point(dtype, fused):
    """jamba's 64 query heads over 8 kv heads, at a narrow width (D=32,
    T=128), through ``ops.flash_attention`` against the reference's entry
    point; with ``fused`` q, k and v are the strided slices of one fused
    QKV output, as the card's kernel takes them.  Tolerance as above:
    atol = rtol = 2e-5 in f32, 2e-2 in bf16."""
    B, T, H, KV, D = 1, 128, 64, 8, 32
    rng = np.random.default_rng(64 + fused)
    qkv = rng.normal(size=(B, T, H + 2 * KV, D)).astype(np.float32)
    arrays = [qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]]
    if not fused:
        arrays = [np.ascontiguousarray(a) for a in arrays]
    (jq, jk, jv), _ = _pair([np.ascontiguousarray(a) for a in arrays], dtype)
    t = torch.from_numpy(qkv).to(getattr(torch, dtype))
    q, k, v = t[:, :, :H], t[:, :, H:H + KV], t[:, :, H + KV:]
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    got = ops.flash_attention(q, k, v, block_q=64, block_kv=64)
    assert got.shape == (B, T, H, D) and got.dtype == q.dtype
    _assert_close(got, jops.flash_attention(jq, jk, jv, block_q=64, block_kv=64), dtype)

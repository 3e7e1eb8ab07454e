"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test needs a CUDA device and skips without one; run them
there with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance atol 1e-5 + rtol 1e-5 (f32 accumulation, and bf16/int8 widened
exactly to f32).  The kernels run the plain versions' arithmetic in the
same order, so in practice they agree to the bit; segmented memory runs
are held to the monolithic kernel at 0.
"""

import pytest
import torch

from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels import fused_dequant as fdq
from repro_torch.kernels import fused_memory as fm
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _round(n, d, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.rand(n, n, generator=g) * 0.5 + 0.1
    tau_up = (torch.rand(n, generator=g) < 0.7).float()
    tau_dd = (torch.rand(n, n, generator=g) < 0.5).float()
    X = torch.randn(n, d, generator=g)
    X = (X * 40).round().clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else X.to(dtype)
    return [t.to(dev) for t in (A, tau_up, tau_dd, X)]


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 1000, 4099, 272282])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_aggregate_kernel_matches_plain(dev, n, d, dtype):
    A, tau_up, tau_dd, X = _round(n, d, dtype, dev, seed=n + d)
    before = fa.fused_aggregate_cuda.launches
    got = fa.fused_aggregate_cuda(A, tau_up, tau_dd, X)
    want = fa.fused_aggregate_plain(A, tau_up, tau_dd, X)
    torch.cuda.synchronize()
    assert fa.fused_aggregate_cuda.launches == before + 1
    assert got.shape == (d,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 10, 27, 1000, 36864])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_row_stream_kernel_matches_plain(dev, n, d, dtype):
    A, tau_up, tau_dd, X = _round(n, d, dtype, dev, seed=2 * n + d)
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    if dtype == torch.int8:
        w = w / 40
    got = fa.row_stream_cuda(w, X)
    want = fa.row_stream_plain(w, X)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


def test_unaligned_rows_take_the_scalar_path(dev):
    """A stack whose base is not 16-byte aligned is still read right."""
    A, tau_up, tau_dd, X = _round(10, 4097, torch.float32, dev, seed=0)
    Xo = X.reshape(-1)[1:1 + 10 * 4096].reshape(10, 4096)  # offset by one float
    got = fa.fused_aggregate_cuda(A, tau_up, tau_dd, Xo)
    torch.testing.assert_close(got, fa.fused_aggregate_plain(A, tau_up, tau_dd, Xo), **TOL)


def test_segments_equal_monolithic_on_the_card(dev):
    A, tau_up, tau_dd, X = _round(10, 5000, torch.float32, dev, seed=1)
    mono = ops.fused_aggregate(A, tau_up, tau_dd, X)
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    cuts = [0, 10, 17, 2048, 5000]
    parts = [ops.row_stream(w, X[:, a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
    torch.testing.assert_close(torch.cat(parts), mono, atol=1e-6, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    A, tau_up, tau_dd, X = _round(4, 64, torch.float32, dev, seed=2)
    with pytest.raises(TypeError):
        fa.fused_aggregate_cuda(A, tau_up, tau_dd, X.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_aggregate_cuda(A, tau_up, tau_dd, X[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        fa.fused_aggregate_cuda(A[:3, :3], tau_up, tau_dd, X)
    with pytest.raises(ValueError, match="block_d"):
        fa.row_stream_cuda(tau_up, X, block_d=100)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 1000, 4099, 272282])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_memory_update_kernel_matches_plain(dev, n, d, dtype):
    A, tau_up, tau_dd, X = _round(n, d, dtype, dev, seed=3 * n + d)
    B = torch.randn(n, d, generator=torch.Generator().manual_seed(d)).to(dev)
    B_plain = B.clone()
    before = fm.fused_memory_update_cuda.launches
    got, got_buf = fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, B)
    want, want_buf = fm.fused_memory_update_plain(A, tau_up, tau_dd, X, B_plain)
    torch.cuda.synchronize()
    assert fm.fused_memory_update_cuda.launches == before + 1
    assert got_buf is B and got.shape == (d,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got_buf, want_buf, **TOL)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_memory_stream_kernel_writes_strided_buffer_columns(dev, n, dtype):
    """Per-segment kernel passes into column views of one buffer equal the
    monolithic kernel, delta and buffer, bitwise."""
    d = 5003
    A, tau_up, tau_dd, X = _round(n, d, dtype, dev, seed=n)
    B = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(dev)
    mono, mono_buf = fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, B.clone())
    mix = ops.mixing_mask(A, tau_dd)
    buf, plain_buf = B.clone(), B.clone()
    cuts = [0, 10, 17, 2048, 4096, d]
    parts, plain_parts = [], []
    for a, b in zip(cuts, cuts[1:]):
        seg = X[:, a:b].contiguous()
        delta, view = fm.memory_stream_cuda(mix, tau_up, seg, buf[:, a:b])
        assert view.data_ptr() == buf[:, a:b].data_ptr()
        parts.append(delta)
        plain_parts.append(fm.memory_stream_plain(mix, tau_up, seg, plain_buf[:, a:b])[0])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), mono) and torch.equal(buf, mono_buf)
    torch.testing.assert_close(torch.cat(parts), torch.cat(plain_parts), **TOL)
    torch.testing.assert_close(buf, plain_buf, **TOL)


def test_memory_wrappers_reject_what_the_kernels_do_not_take(dev):
    A, tau_up, tau_dd, X = _round(4, 64, torch.float32, dev, seed=5)
    B = torch.zeros(4, 64, device=dev)
    with pytest.raises(TypeError):
        fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, B.double())
    with pytest.raises(ValueError, match="contiguous"):
        fm.memory_stream_cuda(ops.mixing_mask(A, tau_dd), tau_up, X, B.t().contiguous().t())
    with pytest.raises(ValueError, match="n <= 109"):
        big = torch.zeros(110, 8, device=dev)
        fm.fused_memory_update_cuda(torch.zeros(110, 110, device=dev),
                                    torch.zeros(110, device=dev),
                                    torch.zeros(110, 110, device=dev), big, big.clone())


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 1000, 4099, 272282])
def test_fused_dequant_kernel_matches_plain(dev, n, d):
    A, tau_up, tau_dd, q = _round(n, d, torch.int8, dev, seed=5 * n + d)
    scale = torch.rand(n, 1, generator=torch.Generator().manual_seed(n)).to(dev) / 40
    before = fdq.fused_dequant_aggregate_cuda.launches
    got = fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, q, scale)
    want = fdq.fused_dequant_aggregate_plain(A, tau_up, tau_dd, q, scale)
    torch.cuda.synchronize()
    assert fdq.fused_dequant_aggregate_cuda.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)
    # the segment path folds the same scales once and streams int8 columns
    ws = ops.fold_dequant_scales(ops.collapsed_weight_row(A, tau_up, tau_dd), scale)
    cuts = sorted({0, min(d, 10), d})
    parts = [ops.dequant_row_stream(ws, q[:, a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), got)

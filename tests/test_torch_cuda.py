"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test needs a CUDA device and skips without one; run them
there with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance atol 1e-5 + rtol 1e-5 (f32 accumulation, and bf16/int8 widened
exactly to f32).  The kernels run the plain versions' arithmetic in the
same order, so in practice they agree to the bit; segmented memory runs
are held to the monolithic kernel at 0.  The grouped kernels (one launch
over a round's segment list, kernels 2, 5 and 9) are held bitwise to their
plain versions, to the per-segment kernels and to the monolithic kernels
(kernel 1 or 6 for kernel 2, kernel 4 for kernel 5, kernel 8 for kernel 9);
kernels 1 and 6 bitwise to their plain versions from n = 1 to 4096.  The clustered kernels and the
dense relay mix are held to their plain versions, to the dense kernels at
C = 1 and segments to the monolithic pass, all bitwise.  Causal flash
attention is held to its plain version (the dense softmax) at atol = rtol
= 2e-5 in f32 (the reference's bound for its kernel) and 2e-2 in bf16,
compared in f32: the online softmax sums in another order.  The chunked
SSD recurrence is held to its plain version at atol = rtol = 5e-4 in f32
(the reference's bound for its kernel) and 2e-2 in bf16, compared in f32:
both compute in f32 and sum the products in another order.  The chunked
engine's graphed chunk (one captured round replayed) is held to the
per-round loop bitwise, with the int8 codec's generator, and so are the
client_sequential, weighted_grad and async rounds (every round metric
too), async with no_trace as well; the captured async round launches
kernel 1 (monolithic), kernel 2 (segmented) or kernel 8 (clustered) once;
colrel's kernel round launches kernel 1 once with ``spmd_axes`` and no mesh.
An adaptive mobility run's chunks are bitwise its per-round run with the
re-optimized alphas swapped in, from one capture; so are the multihop,
topk and randk rounds (randk's generator too).  Telemetry on is bitwise
telemetry off per round and replayed, with the vectors and the int32 streak
bitwise between the two; a resumed run (memory, int8 quantized, no_trace)
is bitwise the uninterrupted one, and so is a restore into a trainer whose
round is captured, without a new capture.  Each family of the model zoo
(dense, MoE, RWKV6, VLM, jamba with its experts) at its smoke config in
f32 on the card is held to the port's CPU path on the same params at
ZOO_TOL; ``apply_moe`` on the card gives the same bits twice, and breaks
top-k ties toward the lower expert; RWKV6's decode states are each
layer's own.  The ``train`` step kind of ``launch/steps.py`` on the zoo's
smoke LMs (collapse and kernel 1), chunked against per round, bitwise; and
learning-rate schedules (Theorem 1's decay, a warm-up cosine under AdamW)
under a captured round, the device step counter advancing on each replay,
bitwise the eager rounds.  ``sample_ge_rounds`` draws a whole GE trace on
the card; the dry run's fake trace of qwen3-0.6b's smoke steps has the
card's FLOPs and a peak within 10% of the card's.
"""

import pytest
import torch

from _torch_segments import SEGMENT_WIDTHS
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels import fused_dequant as fdq
from repro_torch.kernels import fused_memory as fm
from repro_torch.kernels import ops
from repro_torch.kernels import relay_block as rb
from repro_torch.kernels import relay_mix as rm
from repro_torch.kernels import ssd_scan as ssd

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


# -- one launch over a round's segment list (kernels 2 and 5) ------------------

@pytest.mark.parametrize("n", [1, 4, 10, 33, 109])
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_row_stream_segments_kernel_matches_plain_bitwise(dev, n, widths, dtype):
    widths = SEGMENT_WIDTHS[widths]
    A, tau_up, tau_dd, X = _round(n, sum(widths), dtype, dev, seed=7 * n + len(widths))
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    if dtype == torch.int8:
        scale = torch.full((n, 1), 1 / 40, device=dev)
        w = ops.fold_dequant_scales(w, scale)
        mono = fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, X, scale)
    else:
        mono = fa.fused_aggregate_cuda(A, tau_up, tau_dd, X)
    segments = [s.contiguous() for s in X.split(list(widths), dim=1)]
    before = fa.row_stream_segments_cuda.launches
    got = fa.row_stream_segments_cuda(w, segments)
    torch.cuda.synchronize()
    assert fa.row_stream_segments_cuda.launches == before + 1
    assert got.shape == (sum(widths),) and got.dtype == torch.float32
    assert torch.equal(got, fa.row_stream_segments_plain(w, segments))
    assert torch.equal(got, torch.cat([fa.row_stream_cuda(w, s) for s in segments]))
    assert torch.equal(got, mono)


@pytest.mark.parametrize("n", [1, 4, 10, 33, 109])
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "column_views"])
def test_memory_stream_segments_kernel_matches_plain_bitwise(dev, n, widths, dtype, views):
    """Segments as their own tensors (as the strategy ravels them) or as
    column views of one stack (row stride d); the grouped launch writes the
    buffer it was given."""
    widths = SEGMENT_WIDTHS[widths]
    d = sum(widths)
    A, tau_up, tau_dd, X = _round(n, d, dtype, dev, seed=11 * n + len(widths))
    B = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(dev)
    mix = ops.mixing_mask(A, tau_dd)
    segments = [s if views else s.contiguous() for s in X.split(list(widths), dim=1)]
    buf, plain_buf, seg_buf, mono_buf = (B.clone() for _ in range(4))
    before = fm.memory_stream_segments_cuda.launches
    got, out = fm.memory_stream_segments_cuda(mix, tau_up, segments, buf)
    torch.cuda.synchronize()
    assert fm.memory_stream_segments_cuda.launches == before + 1
    assert out is buf and got.shape == (d,) and got.dtype == torch.float32
    want, _ = fm.memory_stream_segments_plain(mix, tau_up, segments, plain_buf)
    assert torch.equal(got, want) and torch.equal(buf, plain_buf)
    parts, off = [], 0
    for s in segments:
        parts.append(fm.memory_stream_cuda(mix, tau_up, s, seg_buf[:, off:off + s.shape[1]])[0])
        off += s.shape[1]
    assert torch.equal(got, torch.cat(parts)) and torch.equal(buf, seg_buf)
    mono, _ = fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, mono_buf)
    assert torch.equal(got, mono) and torch.equal(buf, mono_buf)


def test_grouped_kernels_take_a_full_segment_table(dev):
    """MAX_SEGMENTS segments in one launch, 16-byte and scalar ones mixed;
    one more is refused before any launch."""
    count = fa.MAX_SEGMENTS
    widths = [1 + (37 * i) % 300 for i in range(count)]
    A, tau_up, tau_dd, X = _round(10, sum(widths), torch.float32, dev, seed=3)
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    mix = ops.mixing_mask(A, tau_dd)
    segments = [s.contiguous() for s in X.split(widths, dim=1)]
    assert torch.equal(fa.row_stream_segments_cuda(w, segments),
                       fa.row_stream_segments_plain(w, segments))
    B = torch.randn(10, sum(widths), device=dev)
    buf, plain_buf = B.clone(), B.clone()
    got, _ = fm.memory_stream_segments_cuda(mix, tau_up, segments, buf)
    want, _ = fm.memory_stream_segments_plain(mix, tau_up, segments, plain_buf)
    assert torch.equal(got, want) and torch.equal(buf, plain_buf)
    before = (fa.row_stream_segments_cuda.launches, fm.memory_stream_segments_cuda.launches)
    more = segments + segments[:1]
    with pytest.raises(ValueError, match=f"1 to {count} segments"):
        fa.row_stream_segments_cuda(w, more)
    with pytest.raises(ValueError, match=f"1 to {count} segments"):
        fm.memory_stream_segments_cuda(mix, tau_up, more,
                                       torch.zeros(10, sum(widths) + widths[0], device=dev))
    assert (fa.row_stream_segments_cuda.launches,
            fm.memory_stream_segments_cuda.launches) == before


def test_grouped_wrappers_reject_what_the_kernels_do_not_take(dev):
    seg = torch.zeros(4, 16, device=dev)
    w, mix, tu = torch.ones(4, device=dev), torch.eye(4, device=dev), torch.ones(4, device=dev)
    buf = torch.zeros(4, 32, device=dev)
    for other in (seg.to(torch.bfloat16), torch.zeros(5, 16, device=dev), seg.cpu()):
        with pytest.raises(ValueError, match="share the first one's device, dtype and n"):
            fa.row_stream_segments_cuda(w, [seg, other])
        with pytest.raises(ValueError, match="share the first one's device, dtype and n"):
            fm.memory_stream_segments_cuda(mix, tu, [seg, other], buf)
    with pytest.raises(ValueError, match="tile"):
        fm.memory_stream_segments_cuda(mix, tu, [seg, seg], torch.zeros(4, 31, device=dev))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.memory_stream_segments_cuda(mix, tu, [seg, seg], buf.cpu())
    with pytest.raises(TypeError):
        fm.memory_stream_segments_cuda(mix, tu, [seg.double(), seg.double()], buf)
    with pytest.raises(ValueError, match="contiguous"):
        fa.row_stream_segments_cuda(w, [torch.zeros(4, 32, device=dev)[:, ::2]])


# -- kernel 9 over a round's segment list -------------------------------------

@pytest.mark.parametrize("C,m", [(2, 5), (3, 4), (1, 1)], ids=lambda v: str(v))
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_row_stream_segments_kernel_matches_plain_bitwise(dev, C, m, widths, dtype):
    """Grouped kernel 9 against its plain version, the per-segment kernel 9
    and kernel 8, bitwise; one count a call."""
    widths = SEGMENT_WIDTHS[widths]
    Ab, tau_up, tau_b, X = _blocks(C, m, sum(widths), dtype, dev, seed=C * m + len(widths))
    w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
    segments = [s.contiguous() for s in X.split(list(widths), dim=1)]
    before = rb.block_row_stream_segments_cuda.launches
    got = rb.block_row_stream_segments_cuda(w, segments)
    torch.cuda.synchronize()
    assert rb.block_row_stream_segments_cuda.launches == before + 1
    assert got.shape == (sum(widths),) and got.dtype == torch.float32
    assert torch.equal(got, rb.block_row_stream_segments_plain(w, segments))
    assert torch.equal(got, torch.cat([rb.block_row_stream_cuda(w, s) for s in segments]))
    assert torch.equal(got, rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X))


@pytest.mark.parametrize("n", [1, 4, 10, 33])
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_row_stream_segments_at_one_cluster_equal_grouped_kernel_2(dev, n, widths, dtype):
    widths = SEGMENT_WIDTHS[widths]
    A, tau_up, tau_dd, X = _round(n, sum(widths), dtype, dev, seed=3 * n + len(widths))
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    segments = [s.contiguous() for s in X.split(list(widths), dim=1)]
    assert torch.equal(rb.block_row_stream_segments_cuda(w.reshape(1, n), segments),
                       fa.row_stream_segments_cuda(w, segments))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_row_stream_segments_at_population_scale(dev, dtype):
    """n = 16,384 as C = 256 clusters of m = 64, past the dense kernels'
    4096: the weight row is read through the cache."""
    widths = SEGMENT_WIDTHS["off_grid"]
    Ab, tau_up, tau_b, X = _blocks(256, 64, sum(widths), dtype, dev, seed=16)
    w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
    segments = [s.contiguous() for s in X.split(list(widths), dim=1)]
    got = rb.block_row_stream_segments_cuda(w, segments)
    assert torch.equal(got, rb.block_row_stream_segments_plain(w, segments))
    assert torch.equal(got, rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X))


def test_block_row_stream_segments_wrapper_rejects_what_the_kernel_does_not_take(dev):
    seg, w = torch.zeros(10, 16, device=dev), torch.ones(2, 5, device=dev)
    before = rb.block_row_stream_segments_cuda.launches
    for other in (seg.to(torch.bfloat16), torch.zeros(12, 16, device=dev), seg.cpu()):
        with pytest.raises(ValueError, match="share the first one's device, dtype and n"):
            rb.block_row_stream_segments_cuda(w, [seg, other])
    with pytest.raises(ValueError, match="C\\*m = 12"):
        rb.block_row_stream_segments_cuda(torch.ones(3, 4, device=dev), [seg, seg])
    with pytest.raises(ValueError, match=f"1 to {fa.MAX_SEGMENTS} segments"):
        rb.block_row_stream_segments_cuda(w, [seg] * (fa.MAX_SEGMENTS + 1))
    with pytest.raises(TypeError):
        rb.block_row_stream_segments_cuda(w, [seg.to(torch.int8), seg.to(torch.int8)])
    with pytest.raises(ValueError, match="contiguous"):
        rb.block_row_stream_segments_cuda(w, [torch.zeros(10, 32, device=dev)[:, ::2]])
    with pytest.raises(ValueError, match="w: on cpu"):
        rb.block_row_stream_segments_cuda(w.cpu(), [seg])
    assert rb.block_row_stream_segments_cuda.launches == before


# -- the collapse of kernels 1 and 6 -------------------------------------------

# n across the collapse's load batches (16 terms): one term, one batch, a
# batch and one, the main path's 10, and the wrappers' largest n
COLLAPSE_NS = [1, 4, 10, 16, 17, 33, 4096]


@pytest.mark.parametrize("n", COLLAPSE_NS)
@pytest.mark.parametrize("d", [272282, 272281, 4099])
def test_fused_dequant_kernel_equals_plain_bitwise_at_every_block_d(dev, n, d):
    """Kernel 6 against its plain version, bitwise, on the 16-byte path
    (d = 272,282) and the scalar one, at block_d 16, 2048 and 2^20."""
    if n == 4096:  # both paths at n = 4096 without a 1 GB stack
        d = {272282: 16 * 4099, 272281: 16 * 4099 + 1}.get(d, d)
    A, tau_up, tau_dd, q = _round(n, d, torch.int8, dev, seed=n + d)
    scale = torch.rand(n, 1, generator=torch.Generator().manual_seed(n)).to(dev) / 40
    want = fdq.fused_dequant_aggregate_plain(A, tau_up, tau_dd, q, scale)
    for b in (16, 2048, 1 << 20):
        assert torch.equal(fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, q, scale,
                                                            block_d=b), want)


@pytest.mark.parametrize("n", COLLAPSE_NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_aggregate_kernel_equals_plain_bitwise_across_the_collapse(dev, n, dtype):
    """Kernel 1 takes kernel 6's collapse: bitwise against its plain
    version on the 16-byte path and the scalar one."""
    for d in (4096, 4099):
        A, tau_up, tau_dd, X = _round(n, d, dtype, dev, seed=2 * n + d)
        assert torch.equal(fa.fused_aggregate_cuda(A, tau_up, tau_dd, X),
                           fa.fused_aggregate_plain(A, tau_up, tau_dd, X))


def test_dequant_grid_is_the_launched_grid(dev):
    """The grid kernel 6 reports for the main path's stack: every block
    resident at once, columns a whole number of 16-byte words, at most
    block_d; an empty kernel of that grid launches."""
    g = fdq.dequant_grid(10, 272282)
    assert g["cols"] % 16 == 0 and g["cols"] <= 2048
    assert g["blocks"] == -(-272282 // g["cols"])
    assert g["blocks"] <= g["blocks_per_sm"] * g["sms"]
    assert fdq.dequant_grid(10, 272282, block_d=16)["cols"] == 16
    fdq.launch_floor_cuda(g["blocks"])
    torch.cuda.synchronize()


# -- the clustered kernels and the dense relay mix ----------------------------

CLUSTERINGS = [(1, 4), (1, 10), (2, 5), (1, 33), (3, 11), (64, 16)]  # C, m


def _blocks(C, m, d, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    Ab = torch.rand(C, m, m, generator=g) * 0.5 + 0.1
    tau_up = (torch.rand(C * m, generator=g) < 0.7).float()
    tau_b = (torch.rand(C, m, m, generator=g) < 0.5).float()
    X = torch.randn(C * m, d, generator=g).to(dtype)
    return [t.to(dev) for t in (Ab, tau_up, tau_b, X)]


def _block_kernels_equal_plain(Ab, tau_up, tau_b, X):
    counts = [f.launches for f in (rb.block_relay_mix_cuda, rb.block_fused_aggregate_cuda,
                                   rb.block_row_stream_cuda)]
    mix = rb.block_relay_mix_cuda(Ab, tau_b, X)
    agg = rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)
    w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
    seg = rb.block_row_stream_cuda(w, X)
    torch.cuda.synchronize()
    assert [f.launches for f in (rb.block_relay_mix_cuda, rb.block_fused_aggregate_cuda,
                                 rb.block_row_stream_cuda)] == [c + 1 for c in counts]
    assert mix.dtype == X.dtype and agg.dtype == seg.dtype == torch.float32
    assert torch.equal(mix, rb.block_relay_mix_plain(Ab, tau_b, X))
    assert torch.equal(agg, rb.block_fused_aggregate_plain(Ab, tau_up, tau_b, X))
    assert torch.equal(seg, rb.block_row_stream_plain(w, X))
    assert torch.equal(seg, agg)


@pytest.mark.parametrize("C,m", CLUSTERINGS)
@pytest.mark.parametrize("d", [1, 1000, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernels_match_plain_bitwise(dev, C, m, d, dtype):
    _block_kernels_equal_plain(*_blocks(C, m, d, dtype, dev, seed=C * m + d))


def test_block_kernels_at_population_scale(dev):
    """n = 16,384 as C = 256 clusters of m = 64: the weight row is read
    through the cache, not staged in shared memory."""
    _block_kernels_equal_plain(*_blocks(256, 64, 4099, torch.float32, dev, seed=7))


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernels_at_one_cluster_equal_the_dense_kernels(dev, n, dtype):
    A, tau_up, tau_dd, X = _round(n, 272282, dtype, dev, seed=4 * n)
    assert torch.equal(rb.block_fused_aggregate_cuda(A[None], tau_up, tau_dd[None], X),
                       fa.fused_aggregate_cuda(A, tau_up, tau_dd, X))
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    assert torch.equal(rb.block_row_stream_cuda(w.reshape(1, n), X), fa.row_stream_cuda(w, X))
    assert torch.equal(rb.block_relay_mix_cuda(A[None], tau_dd[None], X),
                       rm.relay_mix_cuda(ops.mixing_mask(A, tau_dd), X))


def test_block_segments_equal_monolithic_on_the_card(dev):
    Ab, tau_up, tau_b, X = _blocks(2, 5, 5000, torch.float32, dev, seed=1)
    mono = ops.block_fused_aggregate(Ab, tau_up, tau_b, X)
    w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
    cuts = [0, 10, 17, 2048, 5000]
    parts = [ops.block_row_stream(w, X[:, a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), mono)


@pytest.mark.parametrize("n", [1, 4, 10, 16, 33, 64, 110])
@pytest.mark.parametrize("d", [1, 3, 1000, 4097, 4099, 2**20, 2**20 + 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relay_mix_kernel_matches_plain_bitwise(dev, n, d, dtype):
    """Rows of 2^20 elements (and of 1000 in f32) take the 16-byte path,
    the rest the scalar one; n past 16 takes the streaming form (x in
    4-row groups, 16 or 8 output rows at a time)."""
    g = torch.Generator().manual_seed(n + d)
    M = torch.randn(n, n, generator=g).to(dev)
    X = torch.randn(n, d, generator=g).to(dtype).to(dev)
    before = rm.relay_mix_cuda.launches
    got = rm.relay_mix_cuda(M, X)
    torch.cuda.synchronize()
    assert rm.relay_mix_cuda.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, rm.relay_mix_plain(M, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relay_mix_kernel_reads_a_row_misaligned_stack(dev, dtype):
    """A stack that starts at element 1 of its storage: every row is off the
    16-byte grid though d is a whole number of 16-byte words."""
    n, d = 16, 4096
    g = torch.Generator().manual_seed(5)
    X = torch.randn(n * d + 1, generator=g).to(dtype).to(dev)[1:].view(n, d)
    assert X.data_ptr() % 16 != 0
    M = torch.randn(n, n, generator=g).to(dev)
    got = rm.relay_mix_cuda(M, X)
    torch.cuda.synchronize()
    assert torch.equal(got, rm.relay_mix_plain(M, X))


@pytest.mark.parametrize("C,m", [(1, 1), (2, 5), (4, 16), (3, 17), (8, 33), (2, 110), (300, 4),
                                 (70000, 1)])
@pytest.mark.parametrize("d", [3, 1024, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_relay_mix_kernel_matches_plain_bitwise(dev, C, m, d, dtype):
    """Clusters past the grid's 65,535 rows (C = 70,000) are walked by the
    blocks in turn, each staging its cluster's mask."""
    if C * m * d > 2**24:
        d = 8
    Ab, _, tau_b, X = _blocks(C, m, d, dtype, dev, seed=C + m + d)
    before = rb.block_relay_mix_cuda.launches
    got = rb.block_relay_mix_cuda(Ab, tau_b, X)
    torch.cuda.synchronize()
    assert rb.block_relay_mix_cuda.launches == before + 1
    assert torch.equal(got, rb.block_relay_mix_plain(Ab, tau_b, X))


def test_block_wrappers_reject_what_the_kernels_do_not_take(dev):
    Ab, tau_up, tau_b, X = _blocks(2, 5, 64, torch.float32, dev, seed=2)
    with pytest.raises(TypeError):
        rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X.double())
    with pytest.raises(ValueError, match="contiguous"):
        rb.block_relay_mix_cuda(Ab, tau_b, X[:, ::2])
    with pytest.raises(ValueError, match="stack"):
        rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X[:9])
    with pytest.raises(ValueError, match="shape"):
        rb.block_fused_aggregate_cuda(Ab, tau_up[:9], tau_b, X)
    with pytest.raises(ValueError, match="block_d"):
        rb.block_row_stream_cuda(tau_up.reshape(2, 5), X, block_d=100)
    with pytest.raises(ValueError, match="m <= 110"):
        big = torch.zeros(1, 111, 111, device=dev)
        rb.block_relay_mix_cuda(big, big, torch.zeros(111, 8, device=dev))


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("shape", [(2, 128, 64), (8, 256, 32), (2, 192, 128), (64, 1024, 64),
                                   (3, 1, 64), (5, 77, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, shape, dtype):
    """The chip-smoke shapes (T=192 is a ragged tail at the kernel's
    128-row tiles) and two more ragged ones."""
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev) for _ in range(3))
    before = fl.flash_attention_cuda.launches
    got = fl.flash_attention_cuda(q, k, v)
    want = fl.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fl.flash_attention_cuda.launches == before + 1
    assert got.shape == shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_gqa_entry_point_launches_once(dev):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 256, 16, 64, generator=g).to(dev)
    k, v = (torch.randn(2, 256, 8, 64, generator=g).to(dev) for _ in range(2))
    before = fl.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v)
    assert fl.flash_attention_cuda.launches == before + 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.randn(2, 128, 64, device=dev)
    with pytest.raises(TypeError):
        fl.flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn(2, 128, 48, device=dev)
        fl.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.randn(2, 128, 128, device=dev)[:, :, ::2]
        fl.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="share shape"):
        fl.flash_attention_cuda(q, q[:, :64].contiguous(), q)


def _fused_qkv_views(B, T, H, KV, D, dtype, dev, seed):
    """q (B, T, H, D), k and v (B, T, KV, D) sliced from one fused QKV
    projection output (B, T, H + 2 KV, D): strided, not contiguous."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, T, H + 2 * KV, D, generator=g).to(dtype).to(dev)
    return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]


def _flash_plain_gqa(q, k, v):
    """The plain version on the heads-first broadcast copies, (B, T, H, D)."""
    B, T, H, D = q.shape
    G = H // k.shape[2]

    def heads_first(x):
        return x.transpose(1, 2).reshape(B * H, T, D)

    out = fl.flash_attention_plain(heads_first(q), heads_first(k.repeat_interleave(G, 2)),
                                   heads_first(v.repeat_interleave(G, 2)))
    return out.reshape(B, H, T, D).transpose(1, 2)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 77, 192, 1024])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_flash_attention_bf16_strided_gqa_views(dev, T, D, group):
    """The bf16 kernel on q, k, v sliced from a fused QKV output
    (strided views, H/KV = group), against the plain version on the
    broadcast copies; ragged T at the 128-row query tiles and the 64-key
    kv tiles."""
    KV = 2
    q, k, v = _fused_qkv_views(2, T, KV * group, KV, D, torch.bfloat16, dev, seed=T + D + group)
    assert not q.is_contiguous() and not k.is_contiguous()
    before = fl.flash_attention_cuda.launches
    got = fl.flash_attention_cuda(q, k, v)
    want = _flash_plain_gqa(q, k, v)
    torch.cuda.synchronize()
    assert fl.flash_attention_cuda.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("T,D,group", [(1, 32, 1), (77, 64, 2), (192, 128, 8), (256, 64, 8)])
def test_flash_attention_f32_strided_gqa_views(dev, T, D, group):
    """The f32 CUDA-core kernel on the same strided GQA views, at the
    reference's f32 bound."""
    q, k, v = _fused_qkv_views(2, T, 2 * group, 2, D, torch.float32, dev, seed=T + D)
    before = fl.flash_attention_cuda.launches
    got = fl.flash_attention_cuda(q, k, v)
    want = _flash_plain_gqa(q, k, v)
    torch.cuda.synchronize()
    assert fl.flash_attention_cuda.launches == before + 1
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_flash_attention_entry_point_reads_views_in_place(dev):
    """ops.flash_attention at jamba's 64/8 head ratio hands the strided
    views to the kernel: one launch, and the same output as the kernel on
    contiguous copies."""
    q, k, v = _fused_qkv_views(1, 256, 64, 8, 128, torch.bfloat16, dev, seed=3)
    before = fl.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v)
    assert fl.flash_attention_cuda.launches == before + 1
    assert torch.equal(got, fl.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                                    v.contiguous()))


def test_flash_wrapper_rejects_unaligned_rows(dev):
    x = torch.randn(2, 64, 3, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.flash_attention_cuda(x[:, :, :, :], x[:, :, :1], x.reshape(-1)[4:4 + 2 * 64 * 64]
                                .reshape(2, 64, 1, 64))
    with pytest.raises(ValueError, match="query heads"):
        fl.flash_attention_cuda(x, x[:, :, :2], x[:, :, :2])


# -- the weighted row stream shared by kernels 1, 2, 6, 8 and 9 ---------------


@pytest.mark.parametrize("C,m,d", [(C, m, d) for C, m in ((1, 4), (2, 5), (1, 10), (3, 11), (1, 33))
                                   for d in (272282, 272281, 36864, 17)]
                         + [(1, 64, 4099), (4096, 1, 4099), (64, 16, 4099), (256, 64, 4099),
                            (256, 64, 17)])
def test_block_fused_aggregate_bitwise_over_the_stream_grid(dev, C, m, d):
    """Kernel 8 against its plain version, bitwise, at the main path's d, a
    ragged d (the scalar path) and segment sizes, from n = 4 to n = 16,384
    (256 clusters of 64) and n = 4096 as 4096 clusters of 1; one count a
    call."""
    Ab, tau_up, tau_b, X = _blocks(C, m, d, torch.float32, dev, seed=C * m + d)
    before = rb.block_fused_aggregate_cuda.launches
    got = rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)
    torch.cuda.synchronize()
    assert rb.block_fused_aggregate_cuda.launches == before + 1
    assert torch.equal(got, rb.block_fused_aggregate_plain(Ab, tau_up, tau_b, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [272282, 272281, 4099])
def test_stream_result_is_independent_of_block_d(dev, dtype, d):
    """block_d only bounds the columns a block takes: kernels 1, 2, 6, 8
    and 9 give the same bits at every bound, and equal their plain
    versions."""
    A, tau_up, tau_dd, X = _round(10, d, dtype, dev, seed=d)
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    rows = [fa.row_stream_cuda(w, X, block_d=b) for b in (16, 2048, 1 << 20)]
    assert all(torch.equal(r, rows[0]) for r in rows)
    assert torch.equal(rows[0], fa.row_stream_plain(w, X))
    if dtype == torch.int8:
        scale = torch.rand(10, 1, generator=torch.Generator().manual_seed(d)).to(dev) / 40
        outs = [fdq.fused_dequant_aggregate_cuda(A, tau_up, tau_dd, X, scale, block_d=b)
                for b in (16, 2048, 1 << 20)]
        assert all(torch.equal(o, outs[0]) for o in outs)
        assert torch.equal(outs[0], fdq.fused_dequant_aggregate_plain(A, tau_up, tau_dd, X, scale))
        return
    outs = [fa.fused_aggregate_cuda(A, tau_up, tau_dd, X, block_d=b) for b in (16, 2048, 1 << 20)]
    outs += [rb.block_fused_aggregate_cuda(A[None], tau_up, tau_dd[None], X, block_d=b)
             for b in (16, 2048, 1 << 20)]
    outs += [rb.block_row_stream_cuda(w.reshape(1, 10), X, block_d=b) for b in (16, 2048, 1 << 20)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(outs[0], fa.fused_aggregate_plain(A, tau_up, tau_dd, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [272282, 272281, 4099])
def test_memory_result_is_independent_of_block_d(dev, dtype, d):
    """block_d only bounds the columns a block takes: kernel 4 and the
    grouped kernel 5 give the same bits, delta and buffer, at every bound,
    and equal their plain versions."""
    A, tau_up, tau_dd, X = _round(10, d, dtype, dev, seed=d)
    B = torch.randn(10, d, generator=torch.Generator().manual_seed(d)).to(dev)
    mix = ops.mixing_mask(A, tau_dd)
    widths = SEGMENT_WIDTHS["cifar_cnn_full"] if d == 272282 else (1, 10, d - 11)
    segments = [s.contiguous() for s in X.split(list(widths), dim=1)]
    outs = []
    for b in (16, 2048, 1 << 20):
        buf = B.clone()
        outs.append((fm.fused_memory_update_cuda(A, tau_up, tau_dd, X, buf, block_d=b)[0], buf))
        buf = B.clone()
        outs.append((fm.memory_stream_segments_cuda(mix, tau_up, segments, buf, block_d=b)[0],
                     buf))
    plain_buf = B.clone()
    want = fm.fused_memory_update_plain(A, tau_up, tau_dd, X, plain_buf)[0]
    for delta, buf in outs:
        assert torch.equal(delta, want) and torch.equal(buf, plain_buf)


SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def _ssd_inputs(shape, dtype, dev, seed):
    BH, T, Dk, Dv = shape
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(BH, T, Dk, generator=g).to(dtype).to(dev) for _ in range(2))
    v = torch.randn(BH, T, Dv, generator=g).to(dtype).to(dev)
    return q, k, v, (-torch.rand(BH, T, generator=g)).to(dev)


@pytest.mark.parametrize("shape,chunk", [((2, 128, 8, 16), 16), ((2, 128, 8, 16), 32),
                                         ((1, 64, 4, 4), 16), ((1, 64, 4, 4), 32),
                                         ((3, 96, 16, 32), 16), ((3, 96, 16, 32), 32),
                                         ((8, 256, 16, 64), 64), ((2, 128, 32, 64), 64),
                                         ((2, 30, 5, 8), 10), ((2, 64, 16, 64), 64),
                                         ((4, 16, 8, 16), 16), ((2, 1, 4, 4), 1),
                                         ((3, 33, 32, 32), 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(dev, shape, chunk, dtype):
    """The reference test's shapes and chunks, jamba's per-head shape
    (Dk 16, Dv 64, chunk 64), the largest shared-memory case (Dk 32), a
    chunk off the 4-row tiles, and T equal to one chunk (no state carried,
    nothing prefetched)."""
    q, k, v, logd = _ssd_inputs(shape, dtype, dev, seed=sum(shape) + chunk)
    before = ssd.ssd_scan_cuda.launches
    got = ssd.ssd_scan_cuda(q, k, v, logd, chunk=chunk)
    want = ssd.ssd_scan_plain(q, k, v, logd, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_cuda.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [1, 10, 16, 33, 64])
@pytest.mark.parametrize("dk", [4, 5, 16, 32])
@pytest.mark.parametrize("dv", ssd.VALUE_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_covers_every_tile_class(dev, chunk, dk, dv, dtype):
    """Every (chunk, Dk, Dv) class the wrapper admits, three chunks a
    slice: chunks off the 16-row MMA tiles, Dk below, at and past one
    16-wide k-step (4 and 5 take element copies), each value width."""
    q, k, v, logd = _ssd_inputs((3, 3 * chunk, dk, dv), dtype, dev, seed=chunk + dk + dv)
    got = ssd.ssd_scan_cuda(q, k, v, logd, chunk=chunk)
    want = ssd.ssd_scan_plain(q, k, v, logd, chunk=chunk)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("N", [5, 16, 32])
@pytest.mark.parametrize("P", [4, 16, 64])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("offset", [40, 41])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_takes_the_mamba_views(dev, N, P, chunk, offset, dtype):
    """(B, H, T, .) operands as the Mamba mixer passes them: q and k one
    (B, T, N) slice of a wider tensor broadcast over the heads, v a
    (B, T, H, P) tensor permuted; the output comes back in v's layout.  q
    and k start on the 16-byte grid (offset 40, N = 16, 32: 16-byte copies)
    or off it (offset 41, or N = 5: element copies)."""
    B, T, H = 2, 128, 6
    g = torch.Generator().manual_seed(0)
    xbc = torch.randn(B, T, offset + 2 * N, generator=g).to(dtype).to(dev)
    k, q = (t[:, None].expand(B, H, T, N)
            for t in (xbc[..., offset:offset + N], xbc[..., offset + N:]))
    v = torch.randn(B, T, H, P, generator=g).to(dtype).to(dev).permute(0, 2, 1, 3)
    logd = (-torch.rand(B, T, H, generator=g)).to(dev).permute(0, 2, 1)
    before = ssd.ssd_scan_cuda.launches
    got = ops.ssd_scan(q, k, v, logd, chunk=chunk)
    assert ssd.ssd_scan_cuda.launches == before + 1
    assert got.shape == (B, H, T, P) and got.permute(0, 2, 1, 3).is_contiguous()
    flat = [x.reshape(B * H, T, x.shape[-1]).contiguous() for x in (q, k, v)]
    want = ssd.ssd_scan_plain(*flat, logd.reshape(B * H, T).contiguous(), chunk=chunk)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(got.reshape(B * H, T, P).float(), want.float(), atol=tol, rtol=tol)


def test_mamba_layer_kernel_matches_plain_on_the_card(dev):
    """One Mamba mixer of the jamba smoke config (d_model 128, bf16): the
    zero-state forward through the kernel against the kernel's plain
    version, one launch."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import mamba

    cfg = get_arch("jamba-1.5-large-398b").smoke().replace(moe_every=0, dtype="bfloat16")
    p = mamba.init_mamba(cfg, torch.Generator(device=dev).manual_seed(0))
    x = torch.randn(2, 64, cfg.d_model, device=dev).to(torch.bfloat16)
    before = ssd.ssd_scan_cuda.launches
    got, _ = mamba.mamba_forward(cfg, p, x)
    assert ssd.ssd_scan_cuda.launches == before + 1
    want, _ = mamba.mamba_forward(cfg, p, x, ssd_kernel=False)
    assert ssd.ssd_scan_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v, logd = _ssd_inputs((2, 64, 8, 16), torch.float32, dev, seed=0)
    with pytest.raises(TypeError):
        ssd.ssd_scan_cuda(q.double(), k.double(), v.double(), logd)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_cuda(q, k, v, logd.bfloat16())
    with pytest.raises(ValueError, match="Dv"):
        ssd.ssd_scan_cuda(q, k, torch.randn(2, 64, 12, device=dev), logd)
    with pytest.raises(ValueError, match="Dk"):
        x = torch.randn(2, 64, 33, device=dev)
        ssd.ssd_scan_cuda(x, x, v, logd)
    with pytest.raises(ValueError, match="at most 64"):
        ssd.ssd_scan_cuda(q, k, v, logd, chunk=128)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssd.ssd_scan_cuda(q, k, v, logd, chunk=48)
    with pytest.raises(ValueError, match="unit stride"):
        x = torch.randn(2, 64, 16, device=dev)[:, :, ::2]
        ssd.ssd_scan_cuda(x, x, v, logd)


# -- the chunked engine: one round captured as a CUDA graph, replayed ---------
#
# A graphed chunk runs the eager round's kernels on the same inputs, so it is
# held to the per-round loop bitwise (cuDNN deterministic, as chip_smoke.py
# runs it).

ENGINE_PATHS = {
    "colrel kernel": dict(strategy="colrel", strategy_options={"fused": "kernel"}),
    "colrel segmented": dict(strategy="colrel", strategy_options={"fused": "kernel"},
                             segment_d=1),
    "colrel collapse": dict(strategy="colrel", strategy_options={"fused": "collapse"}),
    "memory kernel": dict(strategy="memory", strategy_options={"fused": "kernel"},
                          channel="markov"),
    "memory segmented": dict(strategy="memory", strategy_options={"fused": "kernel"},
                             channel="markov", segment_d=1),
    "quantized kernel": dict(strategy="quantized",
                             strategy_options={"codec": "int8", "fused": "kernel"}),
    "quantized segmented": dict(strategy="quantized",
                                strategy_options={"codec": "int8", "fused": "kernel"},
                                segment_d=1),
}


@pytest.fixture
def deterministic(dev):
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield dev
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _assert_trainers_equal(a, b):
    from repro_torch import tree

    for field in ("loss", "participation", "uplink_bits", "weight_sums"):
        x, y = getattr(a.log, field), getattr(b.log, field)
        assert len(x) == len(y) and all(u == v or (u != u and v != v) for u, v in zip(x, y)), field
    for state in ("params", "server_state", "agg_state"):
        for x, y in zip(tree.leaves(getattr(a, state)), tree.leaves(getattr(b, state))):
            if isinstance(x, torch.Generator):
                assert torch.equal(x.get_state(), y.get_state()), state
            else:
                assert x.is_cuda and torch.equal(x, y), state


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_graphed_chunk_equals_per_round(deterministic, path, model):
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    small = dict(local_steps=2, data_size=640, eval_size=64, batch_size=8)
    spec = ExperimentSpec(model=model, **ENGINE_PATHS[path],
                          **(small if model == "cifar_cnn" else {}))
    a, b = build_experiment(spec), build_experiment(spec)
    a.run(6)
    b.run(6, chunk=3)
    _assert_trainers_equal(a.trainer, b.trainer)
    stats = b.trainer._scan_fn.stats
    assert b.trainer._scan_fn.graph is not None and stats["replays"] == 6
    # one aggregation kernel launch a round, captured once; none on the collapse path
    assert sum(stats["captured_launches"].values()) == (0 if "collapse" in path else 1)


@pytest.mark.parametrize("fused,segment_d", [("kernel", 0), ("kernel", 1)])
def test_graphed_chunk_equals_per_round_clustered(deterministic, fused, segment_d):
    from repro_torch import strategies
    from repro_torch.channel import ClusteredStaticChannel
    from repro_torch.core import topology
    from repro_torch.core.weights import optimize_weights_clustered
    from repro_torch.fl.experiment import ExperimentSpec, build_task
    from repro_torch.fl.trainer import FLTrainer

    cmodel = topology.clustered_blocks(10, 0.5, 5, p_intra=0.8, rho=1.0)
    Ab = optimize_weights_clustered(cmodel, sweeps=10, fine_tune_sweeps=10).Ab

    def make():
        loss_fn, init, clients, copt, sopt, T, _ = build_task(ExperimentSpec(model="quadratic"),
                                                              cmodel.n)
        return FLTrainer(loss_fn, init, None, Ab, clients, copt, sopt, local_steps=T,
                         strategy=strategies.get("clustered", fused=fused),
                         channel=ClusteredStaticChannel(cmodel, seed=3), segment_d=segment_d)

    a, b = make(), make()
    a.run(6)
    b.run(6, chunk=3)
    _assert_trainers_equal(a, b)
    name = "block_row_stream_segments_cuda" if segment_d else "block_fused_aggregate_cuda"
    assert b._scan_fn.stats["captured_launches"] == {name: 1}


def test_failed_capture_raises_and_does_not_fall_back(dev):
    """A round that synchronises with the host cannot be captured: the
    engine raises and leaves no graph, and never runs the rounds eagerly."""
    from repro_torch.fl.round import RoundConfig, make_scan_round_fn
    from repro_torch.optim import sgd, sgd_momentum

    def loss_fn(params, batch):
        loss = torch.sum((params["x"] - batch["t"][0]) ** 2)
        if float(loss.detach()) < 0:  # a host read of a device value
            raise AssertionError("unreachable")
        return loss, {}

    rc = RoundConfig(n_clients=2, local_steps=1)
    sopt = sgd_momentum(1.0, beta=0.9)
    scan = make_scan_round_fn(loss_fn, sgd(0.1), sopt, rc)
    p = {"x": torch.zeros(3, device=dev)}
    batches = {"t": torch.ones(2, 2, 1, 1, 3, device=dev)}
    taus = torch.ones(2, 2, device=dev), torch.ones(2, 2, 2, device=dev)
    with pytest.raises(RuntimeError):
        scan(p, sopt.init(p), (), batches, *taus, torch.eye(2, device=dev))
    assert scan.graph is None and torch.equal(p["x"], torch.zeros(3, device=dev))


def test_spmd_axes_outside_a_mesh_launches_kernel_1(dev):
    """``spmd_axes`` is inert outside a mesh: colrel ``fused="kernel"``
    launches kernel 1 once a round with it, as without it, and the rounds
    are bitwise equal."""
    from repro_torch import strategies
    from repro_torch.fl.round import RoundConfig, make_round_fn
    from repro_torch.optim import sgd, sgd_momentum

    def loss_fn(params, batch):
        return torch.sum((params["x"] - batch["t"][0]) ** 2), {}

    g = torch.Generator(device=dev).manual_seed(0)
    batches = {"t": torch.randn(4, 2, 1, 300, generator=g, device=dev)}
    tau_up = (torch.rand(4, generator=g, device=dev) < 0.7).float()
    tau_dd = (torch.rand(4, 4, generator=g, device=dev) < 0.6).float()
    A = torch.rand(4, 4, generator=g, device=dev) * 0.5
    p0 = {"x": torch.zeros(300, device=dev)}
    sopt = sgd_momentum(1.0, beta=0.9)
    outs = []
    for axes in (None, ("data",)):
        rc = RoundConfig(n_clients=4, local_steps=2, spmd_axes=axes,
                         aggregation=strategies.get("colrel", fused="kernel"))
        before = fa.fused_aggregate_cuda.launches
        outs.append(make_round_fn(loss_fn, sgd(0.1), sopt, rc)(p0, sopt.init(p0), (), batches,
                                                               tau_up, tau_dd, A))
        assert fa.fused_aggregate_cuda.launches == before + 1
    assert torch.equal(outs[0][0]["x"], outs[1][0]["x"])


def test_int8_generator_advances_alike_eager_and_replayed(deterministic):
    """The codec's generator after K eager rounds and after K replays of the
    captured round: the same Philox state and the same draws."""
    from repro_torch import strategies
    from repro_torch.fl.round import RoundConfig, make_round_fn, make_scan_round_fn
    from repro_torch.optim import sgd, sgd_momentum

    dev = deterministic

    def loss_fn(params, batch):
        return torch.sum((params["x"] - batch["t"][0]) ** 2), {}

    rc = RoundConfig(n_clients=4, local_steps=2,
                     aggregation=strategies.get("quantized", codec="int8", fused="kernel"))
    strategy = rc.resolve_strategy()
    sopt = sgd_momentum(1.0, beta=0.9)
    g = torch.Generator(device=dev).manual_seed(0)
    K = 5
    batches = {"t": torch.randn(K, 4, 2, 1, 300, generator=g, device=dev)}
    tau_up = (torch.rand(K, 4, generator=g, device=dev) < 0.7).float()
    tau_dd = (torch.rand(K, 4, 4, generator=g, device=dev) < 0.6).float()
    A = torch.rand(4, 4, generator=g, device=dev) * 0.5
    p0 = {"x": torch.zeros(300, device=dev)}

    round_fn = make_round_fn(loss_fn, sgd(0.1), sopt, rc)
    p, ss, ag = p0, sopt.init(p0), strategy.init_state(4, 300, device=dev)
    for i in range(K):
        p, ss, ag, _ = round_fn(p, ss, ag, {"t": batches["t"][i]}, tau_up[i], tau_dd[i], A)
    scan = make_scan_round_fn(loss_fn, sgd(0.1), sopt, rc)
    gen = strategy.init_state(4, 300, device=dev)
    sp, _, sag, _ = scan(p0, sopt.init(p0), gen, batches, tau_up, tau_dd, A)
    assert sag[0] is gen[0] and scan.graph is not None
    assert torch.equal(sag[0].get_state(), ag[0].get_state())
    assert torch.equal(sp["x"], p["x"])
    # the next draws agree as well
    assert torch.equal(torch.rand(8, generator=sag[0], device=dev),
                       torch.rand(8, generator=ag[0], device=dev))


# -- the other round modes and async relaying, captured and replayed --------------

ASYNC_OPTIONS = {"gamma": 0.8, "opportunistic": False}  # ages grow on fig2b under markov
MODE_PATHS = {
    "client_sequential": dict(mode="client_sequential"),
    "weighted_grad": dict(mode="weighted_grad", local_steps=1),
    "async kernel": dict(mode="async", async_options=ASYNC_OPTIONS, channel="markov",
                         strategy_options={"fused": "kernel"}),
    "async segmented": dict(mode="async", async_options=ASYNC_OPTIONS, channel="markov",
                            strategy_options={"fused": "kernel"}, segment_d=1),
    "async plain": dict(mode="async", async_options=ASYNC_OPTIONS, channel="markov"),
}
# what the captured round launches on each path: the scalar-collapse modes
# no kernel, async over colrel kernel 1 (monolithic) or kernel 2 (one pass
# over the staging buffer)
MODE_LAUNCHES = {"client_sequential": {}, "weighted_grad": {}, "async plain": {},
                 "async kernel": {"fused_aggregate_cuda": 1},
                 "async segmented": {"row_stream_cuda": 1}}


def _assert_round_metrics_equal(a, b):
    import numpy as np

    assert set(a.round_metrics) == set(b.round_metrics)
    for k, v in a.round_metrics.items():
        np.testing.assert_array_equal(v, b.round_metrics[k], err_msg=k)


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
@pytest.mark.parametrize("path", sorted(MODE_PATHS))
def test_mode_graphed_chunk_equals_per_round(deterministic, path, model):
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    small = dict(data_size=640, eval_size=64, batch_size=8)
    kw = dict(MODE_PATHS[path])
    kw.setdefault("local_steps", 2)
    spec = ExperimentSpec(model=model, **kw, **(small if model == "cifar_cnn" else {}))
    a, b = build_experiment(spec), build_experiment(spec)
    a.run(6)
    b.run(6, chunk=3)
    _assert_trainers_equal(a.trainer, b.trainer)
    _assert_round_metrics_equal(a.trainer, b.trainer)
    stats = b.trainer._scan_fn.stats
    assert b.trainer._scan_fn.graph is not None and stats["replays"] == 6
    assert stats["captured_launches"] == MODE_LAUNCHES[path]
    if path.startswith("async"):
        assert len(a.trainer.round_metrics) == 8 and max(a.trainer.round_metrics["max_age"]) > 0


@pytest.mark.parametrize("path", ["async kernel", "async segmented"])
def test_async_no_trace_chunk_equals_per_round(deterministic, path):
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    spec = ExperimentSpec(model="quadratic", **MODE_PATHS[path])
    a, b = build_experiment(spec), build_experiment(spec)
    a.run(6, no_trace=True)
    b.run(6, chunk=3, no_trace=True)
    _assert_trainers_equal(a.trainer, b.trainer)
    _assert_round_metrics_equal(a.trainer, b.trainer)
    assert b.trainer._sampled_scan_fn.stats["captured_launches"] == MODE_LAUNCHES[path]


def test_async_clustered_launches_kernel_8(deterministic):
    """Async over the clustered strategy: the block taus go through the
    block form of the delivery mask and the round launches kernel 8 once."""
    from repro_torch import strategies
    from repro_torch.channel import ClusteredMarkovChannel, gilbert_elliott_clustered
    from repro_torch.core import topology
    from repro_torch.core.weights import optimize_weights_clustered
    from repro_torch.fl.experiment import ExperimentSpec, build_task
    from repro_torch.fl.trainer import FLTrainer

    cmodel = topology.clustered_blocks(10, 0.5, 5, p_intra=0.8, rho=1.0)
    Ab = optimize_weights_clustered(cmodel, sweeps=10, fine_tune_sweeps=10).Ab

    def make():
        loss_fn, init, clients, copt, sopt, T, _ = build_task(ExperimentSpec(model="quadratic"),
                                                              cmodel.n)
        return FLTrainer(loss_fn, init, None, Ab, clients, copt, sopt, local_steps=T,
                         strategy=strategies.get("clustered", fused="kernel"), mode="async",
                         async_options=ASYNC_OPTIONS,
                         channel=ClusteredMarkovChannel(
                             gilbert_elliott_clustered(cmodel, memory=0.9), seed=3))

    a, b = make(), make()
    a.run(6)
    b.run(6, chunk=3)
    _assert_trainers_equal(a, b)
    _assert_round_metrics_equal(a, b)
    assert b._scan_fn.stats["captured_launches"] == {"block_fused_aggregate_cuda": 1}


@pytest.mark.parametrize("segment_d", [0, 1])
def test_async_zero_blockage_kernel_round_is_sync_bitwise(deterministic, segment_d):
    """All-ones tau_up into the async round over colrel's kernel path: params
    and the shared metrics equal the sync colrel round's to the bit on the
    monolithic path; the segmented path folds the multipliers into the
    weight row, so it is held at atol = rtol = 1e-5."""
    from repro_torch import strategies, tree
    from repro_torch.fl.round import RoundConfig, make_async_round_fn, make_round_fn
    from repro_torch.optim import sgd, sgd_momentum

    dev = deterministic
    n, T = 10, 2
    g = torch.Generator(device=dev).manual_seed(0)

    def loss_fn(params, batch):
        return torch.sum((params["x"] * batch["t"][0]) ** 2) + params["b"].sum(), {}

    batches = {"t": torch.randn(n, T, 1, 4099, generator=g, device=dev)}
    tau_dd = (torch.rand(n, n, generator=g, device=dev) < 0.6).float()
    A = torch.rand(n, n, generator=g, device=dev) * 0.5
    p0 = {"x": torch.randn(4099, generator=g, device=dev), "b": torch.zeros(33, device=dev)}
    copt, sopt = sgd(0.05), sgd_momentum(1.0, beta=0.9)
    inner = strategies.get("colrel", fused="kernel")
    rc = dict(n_clients=n, local_steps=T, segment_d=segment_d)
    sync = make_round_fn(loss_fn, copt, sopt, RoundConfig(**rc, aggregation=inner))
    strategy = strategies.AsyncRelayStrategy(inner=inner)
    asyn = make_async_round_fn(loss_fn, copt, sopt, RoundConfig(**rc, aggregation=strategy))
    args = (batches, torch.ones(n, device=dev), tau_dd, A)
    p, _, _, m = sync(p0, sopt.init(p0), (), *args)
    q, _, st, mq = asyn(p0, sopt.init(p0), strategy.init_state(n, 4132, device=dev), *args)
    for x, y in zip(tree.leaves(p), tree.leaves(q)):
        if segment_d:
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)
        else:
            assert torch.equal(x, y)
    assert float(mq["max_age"]) == 0.0 and not st["age"].any()
    assert torch.equal(m["participation"], mq["participation"])


def test_async_staging_pass_equals_per_leaf_plain(dev):
    """Kernel 2 over the whole (n, d) staging buffer of cifar_cnn_full equals
    the per-leaf plain row stream over its 61 column segments, bitwise."""
    import numpy as np

    widths = SEGMENT_WIDTHS["cifar_cnn_full"]
    bounds = np.cumsum((0,) + widths)
    g = torch.Generator().manual_seed(5)
    staging = torch.randn(10, int(bounds[-1]), generator=g).to(dev)
    w = torch.rand(10, generator=g).to(dev)
    whole = ops.row_stream(w, staging)
    per_leaf = torch.cat([fa.row_stream_plain(w, staging[:, a:b].contiguous())
                          for a, b in zip(bounds[:-1], bounds[1:])])
    assert torch.equal(whole, per_leaf)


# -- adaptive alpha, multihop and the sparsifying codecs, captured and replayed ----

@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
@pytest.mark.parametrize("mode", ["per_client", "async"])
@pytest.mark.parametrize("segment_d", [0, 1])
def test_adaptive_graphed_chunk_swaps_alpha_without_recapture(deterministic, model, mode,
                                                               segment_d):
    """Mobility with re-opts at rounds 2, 5 and 8: each new alpha reaches the
    replayed round through the static A buffer, so the run captures once and
    is bitwise its per-round run; sync and async over colrel's kernels."""
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    small = dict(local_steps=2, data_size=640, eval_size=64, batch_size=8)
    spec = ExperimentSpec(model=model, channel="mobility", adaptive=True, reopt_every=3,
                          strategy_options={"fused": "kernel"}, segment_d=segment_d, mode=mode,
                          **(small if model == "cifar_cnn" else {}))
    a, b = build_experiment(spec), build_experiment(spec)
    a.run(9)
    b.run(9, chunk=3)
    _assert_trainers_equal(a.trainer, b.trainer)
    for field in ("reopt_rounds", "S_est", "S_true", "est_p_err"):
        assert getattr(a.log, field) == getattr(b.log, field), field
    assert b.log.reopt_rounds == [2, 5, 8]
    assert b.trainer.A.is_cuda and torch.equal(a.trainer.A, b.trainer.A)
    stats = b.trainer._scan_fn.stats
    assert stats["captures"] == 1 and stats["replays"] == 9
    segmented = "row_stream_cuda" if mode == "async" else "row_stream_segments_cuda"
    assert stats["captured_launches"] == {segmented if segment_d else "fused_aggregate_cuda": 1}


SPARSE_PATHS = {
    "randk": dict(strategy="quantized",
                  strategy_options={"codec": "randk", "codec_options": {"fraction": 0.25}}),
    "topk": dict(strategy="quantized",
                 strategy_options={"codec": "topk", "codec_options": {"fraction": 0.1}}),
    "multihop": dict(strategy="multihop", strategy_options={"hops": 2}),
    "topk(multihop)": dict(strategy="quantized",
                           strategy_options={"codec": "topk", "inner": "multihop",
                                             "inner_options": {"hops": 2}}),
}


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
@pytest.mark.parametrize("path", sorted(SPARSE_PATHS))
def test_sparse_and_multihop_graphed_chunk_equals_per_round(deterministic, path, model):
    """randk's generator is registered with the graph, so eager rounds and
    replays advance one stream; multihop's source scale is made in the eager
    warm-up round and only read by the captured one."""
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    small = dict(local_steps=2, data_size=640, eval_size=64, batch_size=8)
    spec = ExperimentSpec(model=model, **SPARSE_PATHS[path],
                          **(small if model == "cifar_cnn" else {}))
    a, b = build_experiment(spec), build_experiment(spec)
    a.run(6)
    b.run(6, chunk=3)
    _assert_trainers_equal(a.trainer, b.trainer)
    stats = b.trainer._scan_fn.stats
    assert b.trainer._scan_fn.graph is not None and stats["replays"] == 6
    assert stats["captured_launches"] == {}  # plain PyTorch paths, as in the reference


# -- telemetry and checkpoint/resume on the card -----------------------------------
#
# The instrumented round only reads the plain round's inputs and outputs, so
# telemetry on is bitwise telemetry off, per round and replayed; a resumed run
# is bitwise the uninterrupted one; a restore into a trainer whose round is
# captured writes the generators' states into the objects the graph
# registered, and the replays honour them without a new capture.


def _end(trainer):
    """A trainer's end state, copied (the carry is the engine's static
    buffers, which a later chunk overwrites)."""
    from repro_torch import tree
    from repro_torch.telemetry import VECTOR_METRICS

    leaves = tree.leaves((trainer.params, trainer.server_state, trainer.agg_state,
                          trainer._streak, trainer._channel_state, trainer._channel_gen))
    return dict(log=trainer.log.to_dict(),
                metrics={k: list(v) for k, v in trainer.round_metrics.items()},
                vectors={k: trainer.metrics.vector(k) for k in VECTOR_METRICS},
                state=[x.get_state() if isinstance(x, torch.Generator) else x.clone()
                       for x in leaves if x is not None])


def _assert_same_end(a, b):
    import numpy as np

    assert a["log"].keys() == b["log"].keys() and a["metrics"].keys() == b["metrics"].keys()
    for k in a["log"]:
        assert all(u == v or (u != u and v != v) for u, v in zip(a["log"][k], b["log"][k])), k
        assert len(a["log"][k]) == len(b["log"][k]), k
    for k in a["metrics"]:
        np.testing.assert_array_equal(a["metrics"][k], b["metrics"][k], err_msg=k)
    for k, v in a["vectors"].items():
        assert (v is None) == (b["vectors"][k] is None), k
        if v is not None:
            assert v.dtype == b["vectors"][k].dtype
            np.testing.assert_array_equal(v, b["vectors"][k], err_msg=k)
    assert len(a["state"]) == len(b["state"])
    for x, y in zip(a["state"], b["state"]):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
@pytest.mark.parametrize("path", ["colrel kernel", "memory kernel", "quantized kernel"])
def test_telemetry_is_inert_per_round_and_replayed(deterministic, path, model):
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment
    from repro_torch.telemetry import VECTOR_METRICS

    small = dict(local_steps=2, data_size=640, eval_size=64, batch_size=8)
    spec = ExperimentSpec(model=model, **ENGINE_PATHS[path],
                          **(small if model == "cifar_cnn" else {}))
    off, on, on_ch = (build_experiment(s) for s in (spec, spec.replace(telemetry=True),
                                                    spec.replace(telemetry=True)))
    off.run(6)
    on.run(6)
    on_ch.run(6, chunk=3)
    _assert_trainers_equal(off.trainer, on.trainer)
    _assert_same_end(_end(on.trainer), _end(on_ch.trainer))
    streak = on_ch.trainer._streak
    assert streak.is_cuda and streak.dtype == torch.int32
    assert on_ch.trainer.metrics.vector("outage_streak").dtype.name == "int32"
    assert set(on_ch.trainer.round_metrics) == set(off.trainer.round_metrics) | {"weight_drift"}
    assert all(on_ch.trainer.metrics.vector(k).shape == (6, 10) for k in VECTOR_METRICS)
    stats = on_ch.trainer._scan_fn.stats
    assert stats["captures"] == 1 and stats["replays"] == 6


RESUME_PATHS = {
    "memory kernel": (ENGINE_PATHS["memory kernel"], {}),
    "quantized kernel": (ENGINE_PATHS["quantized kernel"], {}),
    "colrel kernel, no_trace": (dict(ENGINE_PATHS["colrel kernel"], channel="markov"),
                                {"no_trace": True}),
}


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
@pytest.mark.parametrize("path", sorted(RESUME_PATHS))
def test_resume_and_restore_into_a_captured_trainer_are_bitwise(deterministic, path, model,
                                                                 tmp_path):
    """8 rounds in chunks of 4 with a checkpoint every chunk and telemetry:
    a fresh trainer resumed at round 4 ends bitwise the uninterrupted run;
    so does the uninterrupted trainer, which has captured, restored at round
    4: the generators (the int8 codec's, the sampler's) keep their objects,
    so the graph is kept (no new capture) and its replays read the restored
    states."""
    from repro_torch.ckpt import CheckpointWriter
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    kw, run_kw = RESUME_PATHS[path]
    small = dict(local_steps=2, data_size=640, eval_size=64, batch_size=8)
    spec = ExperimentSpec(model=model, telemetry=True, **kw,
                          **(small if model == "cifar_cnn" else {}))
    ref = build_experiment(spec.replace(ckpt_dir=str(tmp_path), ckpt_every=4))
    ref.run(8, chunk=4, **run_kw)
    want = _end(ref.trainer)
    mid = CheckpointWriter(tmp_path).path_for(4)
    assert CheckpointWriter(tmp_path).steps() == [4, 8]
    res = build_experiment(spec.replace(resume_from=str(mid)))
    res.run(8, chunk=4, **run_kw)
    _assert_same_end(want, _end(res.trainer))
    engine = "_sampled_scan_fn" if run_kw else "_scan_fn"
    assert getattr(res.trainer, engine).stats["captures"] == 1
    scan = getattr(ref.trainer, engine)
    graph = scan.graph
    ref.run(8, chunk=4, resume_from=str(mid), **run_kw)
    _assert_same_end(want, _end(ref.trainer))
    assert scan.stats["captures"] == 1 and scan.graph is graph


def test_experiment_fields_run_on_the_card(dev, tmp_path):
    """metrics_dir, profile_dir, ckpt_* and resume_from through
    build_experiment's default device."""
    import json

    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    spec = ExperimentSpec(model="quadratic", rounds=4, chunk=2, metrics_dir=str(tmp_path / "m"),
                          profile_dir=str(tmp_path / "p"), profile_rounds=2, log_every=2,
                          ckpt_dir=str(tmp_path / "c"), ckpt_every=2)
    exp = build_experiment(spec)
    exp.run()
    exp.close()
    assert exp.trainer.device.type == "cuda" and exp.trainer._streak.is_cuda
    man = json.loads((tmp_path / "m" / "manifest.json").read_text())
    assert man["backend"] == "cuda" and man["extra"]["gpu"] == torch.cuda.get_device_name(0)
    assert json.loads(exp.trainer.profile.trace_path.read_text())["traceEvents"]
    again = build_experiment(spec.replace(resume_from=str(tmp_path / "c"), rounds=6))
    again.run()
    assert again.trainer.round == 6 and again.log.rounds == list(range(6))


# ---------------------------------------------------------------------------
# the model zoo on the card
# ---------------------------------------------------------------------------

# f32 on both sides, cuBLAS against the CPU's GEMMs (TF32 off) and, for
# jamba, kernels 10 and 11 against their plain versions; relative to
# max(1, max|cpu|), through attention's nearly one-hot softmaxes
ZOO_TOL = 1e-3


def _zoo_close(got, want):
    got, want = got.float().cpu(), want.float()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= ZOO_TOL * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "internvl2-2b", "jamba-1.5-large-398b"])
def test_zoo_smoke_on_the_card_matches_the_cpu_path(dev, arch):
    from repro_torch import tree
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build

    cfg = get_arch(arch).smoke()
    b = build(cfg)
    params = b.init(torch.Generator().manual_seed(0))
    on_card = tree.map(lambda x: x.to(dev), params)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g)}
    if cfg.frontend_tokens:
        batch["prefix"] = torch.randn(2, cfg.frontend_tokens, cfg.d_model, generator=g)
    prefill = build_step(b, "prefill")
    with torch.inference_mode():
        _zoo_close(prefill(on_card, {k: v.to(dev) for k, v in batch.items()}),
                   prefill(params, batch))
        step = build_step(b, "decode")
        cache, card_cache = b.init_cache(2, 8), b.init_cache(2, 8, device=dev)
        for t in range(8):
            tok = batch["tokens"][:, t:t + 1]
            want, cache = step(params, cache, tok, t)
            got, card_cache = step(on_card, card_cache, tok.to(dev), t)
            _zoo_close(got, want)


def test_apply_moe_on_the_card_is_deterministic_and_breaks_ties_low(dev):
    """granite-moe's MoE layer at full width (40 experts, top-8), 4096
    tokens in bf16: two calls give the same bits (the combine sums each
    token's contributions in order; no atomics)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import moe

    cfg = get_arch("granite-moe-3b-a800m").full()
    p = moe.init_moe(cfg, torch.Generator(device=dev).manual_seed(0))
    x = torch.randn(4, 1024, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)).to(cfg.tdtype)
    y1, aux1 = moe.apply_moe(cfg, p, x)
    y2, aux2 = moe.apply_moe(cfg, p, x)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    assert bool(torch.isfinite(y1.float()).all())
    r = moe.route(cfg, {**p, "router": torch.zeros_like(p["router"])}, x[0, :8])
    assert torch.equal(r.expert.cpu(), torch.arange(cfg.top_k).expand(8, cfg.top_k))


def test_rwkv_decode_states_are_each_layers_own_on_the_card(dev):
    from repro_torch import tree
    from repro_torch.configs.base import get_arch
    from repro_torch.models import build

    cfg = get_arch("rwkv6-1.6b").smoke()
    b = build(cfg)
    params = b.init(torch.Generator(device=dev).manual_seed(0))
    cache = b.init_cache(2, 4, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 1), device=dev)
    _, out = b.decode_step(params, cache, tok, 0)
    assert out is cache
    for x in tree.leaves(cache):
        assert x.is_cuda and x.shape[0] == cfg.n_layers
        assert float(x[0].abs().max()) > 0 and not torch.equal(x[0], x[1])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "internvl2-2b"])
@pytest.mark.parametrize("fused", ["collapse", "kernel"])
def test_train_step_kind_chunk_equals_per_round(deterministic, arch, fused):
    """``build_step(bundle, "train")`` per round against its chunked engine
    (``scan_rounds``, one round captured and replayed) on a zoo LM's smoke
    config: every metric, the params and the server state bitwise."""
    from repro_torch import strategies, tree
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.steps import SERVER_MOMENTUM, build_step
    from repro_torch.models import build
    from repro_torch.optim import sgd_momentum

    dev = deterministic
    cfg = get_arch(arch).smoke()
    bundle = build(cfg)
    n, T, B, S, K = 4, 2, 2, 16, 3
    g = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(g)
    toks = torch.randint(0, cfg.vocab_size, (K, n, T, B, S + 1), generator=g, device=dev)
    batches = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
    if cfg.frontend_tokens:
        batches["prefix"] = torch.randn(K, n, T, B, cfg.frontend_tokens, cfg.d_model,
                                        generator=g, device=dev)
    tau_up = (torch.rand(K, n, generator=g, device=dev) < 0.7).float()
    tau_dd = (torch.rand(K, n, n, generator=g, device=dev) < 0.6).float()
    A = torch.rand(n, n, generator=g, device=dev) * 0.5
    strategy = strategies.get("colrel", fused=fused)
    server = sgd_momentum(1.0, beta=SERVER_MOMENTUM)
    round_fn = build_step(bundle, "train", n_clients=n, aggregation=strategy)
    p, ss, metrics = params, server.init(params), []
    for i in range(K):
        p, ss, _, m = round_fn(p, ss, (), {k: v[i] for k, v in batches.items()}, tau_up[i],
                               tau_dd[i], A)
        metrics.append(m)
    scan = build_step(bundle, "train", n_clients=n, aggregation=strategy, scan_rounds=K)
    sp, sss, _, sm = scan(params, server.init(params), (), batches, tau_up, tau_dd, A)
    assert scan.graph is not None
    for a, b in zip(tree.leaves((sp, sss)), tree.leaves((p, ss))):
        assert torch.equal(a, b)
    for key in round_fn.metric_keys:
        assert torch.equal(sm[key], torch.stack([m[key].float() for m in metrics])), key
    if fused == "kernel":
        assert scan.stats["captured_launches"] == {"fused_aggregate_cuda": 1}


def test_schedules_advance_under_a_captured_round(deterministic):
    """The server optimizer on Theorem 1's schedule, and AdamW on a warm-up
    cosine: K replays of the captured round step the schedule K times from
    the device step counter, bitwise the eager rounds."""
    from repro_torch import tree
    from repro_torch.fl.round import RoundConfig, make_round_fn, make_scan_round_fn
    from repro_torch.optim import adamw, inverse_round_decay, sgd, sgd_momentum, warmup_cosine

    dev = deterministic

    def loss_fn(params, batch):
        return torch.sum((params["x"] - batch["t"][0]) ** 2), {}

    K = 4
    g = torch.Generator(device=dev).manual_seed(0)
    batches = {"t": torch.randn(K, 3, 2, 1, 50, generator=g, device=dev)}
    tau_up = torch.ones(K, 3, device=dev)
    tau_dd = torch.ones(K, 3, 3, device=dev)
    A = torch.full((3, 3), 1.0 / 3, device=dev)
    p0 = {"x": torch.zeros(50, device=dev)}
    for client, server in ((sgd(0.1), sgd_momentum(inverse_round_decay(4.0, 2), beta=0.9)),
                           (adamw(warmup_cosine(0.1, 1, 4)), sgd_momentum(
                               inverse_round_decay(2.0, 1), beta=0.5, nesterov=True))):
        rc = RoundConfig(n_clients=3, local_steps=2)
        round_fn = make_round_fn(loss_fn, client, server, rc)
        p, ss = p0, server.init(p0)
        for i in range(K):
            p, ss, _, _ = round_fn(p, ss, (), {"t": batches["t"][i]}, tau_up[i], tau_dd[i], A)
        scan = make_scan_round_fn(loss_fn, client, server, rc)
        sp, sss, _, _ = scan(p0, server.init(p0), (), batches, tau_up, tau_dd, A)
        assert scan.graph is not None and int(sss["step"]) == K == int(ss["step"])
        for a, b in zip(tree.leaves((sp, sss)), tree.leaves((p, ss))):
            assert torch.equal(a, b)
        # a second chunk continues the schedule from step K
        sp2, sss2, _, _ = scan(sp, sss, (), batches, tau_up, tau_dd, A)
        assert int(sss2["step"]) == 2 * K


def test_sample_ge_rounds_on_the_card(dev):
    """The whole-trace GE sampler draws on its generator's device: float32
    taus there, diagonal 1, symmetric on fully reciprocal links, the same
    trace twice from one seed, each uplink's marginal within 5 standard
    deviations (effective sample size (1 - lam) / (1 + lam))."""
    import numpy as np

    from repro_torch.channel import gilbert_elliott, sample_ge_rounds
    from repro_torch.core import topology

    n, R, lam = 6, 4000, 0.8
    model = topology.fully_connected(n, 0.6, p_c=0.5, rho=1.0)
    params = gilbert_elliott(model, memory=lam)
    ups, dds = sample_ge_rounds(params, torch.Generator(device=dev).manual_seed(0), R)
    assert ups.device.type == dds.device.type == "cuda" and ups.dtype == torch.float32
    assert torch.equal(dds, dds.transpose(1, 2))
    assert bool((torch.diagonal(dds, dim1=1, dim2=2) == 1).all())
    again = sample_ge_rounds(params, torch.Generator(device=dev).manual_seed(0), R)
    assert torch.equal(again[0], ups) and torch.equal(again[1], dds)
    tol = 5 * np.sqrt(model.p * (1 - model.p) / (R * (1 - lam) / (1 + lam)))
    assert np.all(np.abs(ups.mean(0).cpu().numpy() - model.p) < tol)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_estimate_against_the_card(dev, kind):
    """qwen3-0.6b at smoke(): the fake trace's FLOPs equal the card's and
    its peak is within 10% of the card's max_memory_allocated above the
    baseline (the limit phase 13 of chip_smoke.py holds at full width)."""
    from repro_torch import strategies
    from repro_torch.configs.base import InputShape, get_arch
    from repro_torch.launch import dryrun

    shape = {"train": InputShape("t", 64, 16, "train"),
             "prefill": InputShape("p", 256, 4, "prefill"),
             "decode": InputShape("d", 256, 4, "decode")}[kind]
    step, specs = dryrun.prepare("qwen3-0.6b", shape, n_clients=4,
                                 aggregation=strategies.get("colrel", fused=False),
                                 cfg=get_arch("qwen3-0.6b").smoke())
    fake = dryrun.trace(step, specs)
    # a first run allocates what lives past it (cuBLAS's workspace for each
    # thread that runs a GEMM, forward and backward); the second is the step's
    dryrun.measure(step, specs)
    real = dryrun.measure(step, specs)
    assert real["device"].startswith("cuda") and real["finite"]
    assert fake["flops"] == real["flops"] > 0
    assert abs(fake["peak_bytes"] - real["peak_bytes"]) <= 0.10 * real["peak_bytes"]

"""The port's aggregation and relay-mix kernels (plain PyTorch versions,
the CPU path) against the reference's Pallas kernels run in interpret
mode.

Inputs are made with numpy from a seed and handed to both.  Both sides
widen bf16/int8 to f32 exactly and accumulate in f32, so they differ only
in summation order: atol 1e-5 (the bar ``tests/test_fused_aggregate.py``
holds the Pallas kernel to) for every dtype.

Inside the port the grouped row stream (one launch over a round's segment
list) equals the per-segment and the monolithic passes bitwise, on the
CPU through the plain versions; the grouped CUDA wrapper's checks run
before it touches a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_segments import SEGMENT_WIDTHS
from repro.kernels.fused_aggregate import fused_aggregate_pallas, row_stream_pallas
from repro.kernels.relay_block import (
    block_fused_aggregate_pallas,
    block_relay_mix_pallas,
    block_row_stream_pallas,
)
from repro.kernels.relay_mix import relay_mix_pallas
from repro_torch import strategies, tree
from repro_torch.core import flatten
from repro_torch.kernels import fused_aggregate as fa
from repro_torch.kernels import fused_memory as fm
from repro_torch.kernels import ops
from repro_torch.kernels import relay_block as rb
from repro_torch.kernels import relay_mix as rm
from repro_torch.strategies.base import ExecutionContext

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


# -- one launch over a round's segment list -----------------------------------

def _segments_of(x, widths):
    return [s.contiguous() for s in x.split(list(widths), dim=1)]


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_row_stream_segments_equal_per_segment_and_monolithic_bitwise(n, widths, dtype):
    """The grouped plain version against the per-segment passes and the
    monolithic kernel's plain version (kernel 1, or kernel 6 for int8)."""
    widths = SEGMENT_WIDTHS[widths]
    A, tau_up, tau_dd, X = (torch.from_numpy(a)
                            for a in _round_inputs(n, sum(widths), seed=n + len(widths)))
    if dtype == "int8":
        x = (X / INT8_SCALE).round().clamp(-127, 127).to(torch.int8)
        scale = torch.full((n, 1), INT8_SCALE)
        w = ops.fold_dequant_scales(ops.collapsed_weight_row(A, tau_up, tau_dd), scale)
        mono = ops.fused_dequant_aggregate(A, tau_up, tau_dd, x, scale)
    else:
        x = X.to(getattr(torch, dtype))
        w = ops.collapsed_weight_row(A, tau_up, tau_dd)
        mono = ops.fused_aggregate(A, tau_up, tau_dd, x)
    segments = _segments_of(x, widths)
    got = ops.row_stream_segments(w, segments)
    assert got.shape == (sum(widths),) and got.dtype == torch.float32
    assert torch.equal(got, torch.cat([ops.row_stream(w, s) for s in segments]))
    assert torch.equal(got, mono)


def test_segment_ops_on_the_cpu_launch_nothing():
    wrappers = (fa.row_stream_cuda, fa.row_stream_segments_cuda, fm.memory_stream_cuda,
                fm.memory_stream_segments_cuda, fm.fused_memory_update_cuda)
    before = [f.launches for f in wrappers]
    for f in wrappers:
        f.launches = 0
    try:
        A, tau_up, tau_dd, X = (torch.from_numpy(a) for a in _round_inputs(10, 4108, seed=2))
        segments = _segments_of(X, SEGMENT_WIDTHS["off_grid"])
        ops.row_stream_segments(ops.collapsed_weight_row(A, tau_up, tau_dd), segments)
        q = [s.mul(40).round().to(torch.int8) for s in segments]
        ops.row_stream_segments(tau_up, q)
        ops.memory_stream_segments(ops.mixing_mask(A, tau_dd), tau_up, segments,
                                   torch.zeros(10, 4108))
        assert [f.launches for f in wrappers] == [0] * len(wrappers)
    finally:
        for f, b in zip(wrappers, before):
            f.launches = b


def test_grouped_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Checked before any card is touched: CPU tensors, mixed dtypes, a
    segment whose n differs, a buffer the segments do not tile, and more
    segments than the kernel's parameter table holds."""
    seg = torch.zeros(4, 16)
    w, mix, tu, buf = torch.ones(4), torch.eye(4), torch.ones(4), torch.zeros(4, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.row_stream_segments_cuda(w, [seg, seg])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.memory_stream_segments_cuda(mix, tu, [seg, seg], buf)
    for other in (seg.to(torch.bfloat16), torch.zeros(5, 16)):
        with pytest.raises(ValueError, match="share the first one's device, dtype and n"):
            fa.row_stream_segments_cuda(w, [seg, other])
        with pytest.raises(ValueError, match="share the first one's device, dtype and n"):
            fm.memory_stream_segments_cuda(mix, tu, [seg, other], buf)
    for bad in (torch.zeros(4, 33), torch.zeros(5, 32), torch.zeros(32)):
        with pytest.raises(ValueError, match="tile"):
            fm.memory_stream_segments_cuda(mix, tu, [seg, seg], bad)
        with pytest.raises(ValueError, match="tile"):
            fm.memory_stream_segments_plain(mix, tu, [seg, seg], bad)
    for count in (0, fa.MAX_SEGMENTS + 1):
        with pytest.raises(ValueError, match=f"1 to {fa.MAX_SEGMENTS} segments"):
            fa.row_stream_segments_cuda(w, [seg] * count)
        with pytest.raises(ValueError, match=f"1 to {fa.MAX_SEGMENTS} segments"):
            fm.memory_stream_segments_cuda(mix, tu, [seg] * count, torch.zeros(4, 16 * count))


def test_quantized_segment_path_matches_the_reference_row_stream():
    """The quantized strategy's segmented path (one grouped launch a round)
    against the reference's ``row_stream_pallas`` in interpret mode on the
    same int8 segments and folded weights: the codec's segment encoding is
    replayed from the same state, so both sides see the same q."""
    n = 8
    rng = np.random.default_rng(12)
    deltas = {k: torch.from_numpy(rng.normal(size=(n,) + s).astype(np.float32))
              for k, s in {"a": (16, 32), "b": (10,), "c": (3, 3)}.items()}
    A, tau_up, tau_dd, _ = _round_inputs(n, 1, seed=13)
    strategy = strategies.get("quantized", codec="int8", fused="kernel")
    state = strategy.init_state(n, 16 * 32 + 10 + 9)
    got, _ = strategy.aggregate_tree(deltas, *(torch.from_numpy(a) for a in (tau_up, tau_dd, A)),
                                     state, ExecutionContext(n_clients=n, segment_d=1))
    (qs, scale), _ = strategy.codec.encode_segments(
        flatten.ravel_stacked_segments(deltas, dtype=torch.float32), state[0])
    w = (tau_up @ (A * tau_dd.T) / n).astype(np.float32)
    ws = w * (scale.numpy().reshape(-1) / strategy._gain(16 * 32 + 10 + 9))
    for g, q in zip(tree.leaves(got), qs):
        want = row_stream_pallas(jnp.asarray(ws, jnp.float32), jnp.asarray(q.numpy()),
                                 block_d=2048, interpret=True)
        np.testing.assert_allclose(g.reshape(-1).numpy(), np.asarray(want), atol=ATOL, rtol=0)


# -- the clustered (block-sparse) kernels and the dense relay mix -------------
#
# The reference's own bound for its blocked kernels (tests/test_clustered.py)
# is atol 2e-6 + rtol 1e-5 in f32; the (d,) aggregations widen bf16 to f32
# exactly and are held to the same bound.  Its bound for the dense relay-mix
# sweep (tests/test_kernels.py), whose mask is N(0, 1) with up to 33 terms
# a sum and cancels, is 1e-4.  The relay mixes return the stack's dtype, so
# their bf16 outputs may further differ by one bf16 rounding step (2^-7
# relative) where the f32 sums, taken in another order, fall on either side
# of a rounding boundary.

F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=2e-6, rtol=2.0 ** -7)
MIX_F32_TOL = dict(atol=1e-4, rtol=1e-4)
MIX_BF16_TOL = dict(atol=1e-4, rtol=2.0 ** -7)
KSHAPES = [(3, 5, 37, 16), (2, 8, 64, 64), (4, 3, 10, 4), (1, 6, 33, 8)]  # C, m, d, block_d


def _block_inputs(C, m, d, seed):
    rng = np.random.default_rng(seed)
    Ab = rng.uniform(0.1, 2.0, size=(C, m, m)).astype(np.float32)
    tau_b = rng.integers(0, 2, size=(C, m, m)).astype(np.float32)
    tau_up = rng.integers(0, 2, size=(C * m,)).astype(np.float32)
    X = rng.normal(size=(C * m, d)).astype(np.float32)
    return Ab, tau_up, tau_b, X


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("n", [4, 10, 16, 33])
@pytest.mark.parametrize("d", [128, 1000, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relay_mix_plain_matches_pallas(n, d, dtype):
    rng = np.random.default_rng(n * 13 + d)
    M = rng.normal(size=(n, n)).astype(np.float32)
    xj, xt = _stack(rng.normal(size=(n, d)).astype(np.float32), dtype)
    want = relay_mix_pallas(jnp.asarray(M), xj, block_d=512, interpret=True)
    got = rm.relay_mix_plain(torch.from_numpy(M), xt)
    assert got.shape == (n, d) and got.dtype == xt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(MIX_F32_TOL if dtype == "float32" else MIX_BF16_TOL))


@pytest.mark.parametrize("C,m,d,bd", KSHAPES, ids=[f"C{c}m{m}d{d}bd{b}" for c, m, d, b in KSHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_kernels_plain_match_pallas(C, m, d, bd, dtype):
    Ab, tau_up, tau_b, X = _block_inputs(C, m, d, seed=C * 100 + m)
    xj, xt = _stack(X, dtype)
    a, tu, tb = (torch.from_numpy(v) for v in (Ab, tau_up, tau_b))
    aj, tuj, tbj = (jnp.asarray(v) for v in (Ab, tau_up, tau_b))

    mix = rb.block_relay_mix_plain(a, tb, xt)
    assert mix.shape == (C * m, d) and mix.dtype == xt.dtype
    np.testing.assert_allclose(
        _f32(mix), _f32(block_relay_mix_pallas(aj, tbj, xj, block_d=bd, interpret=True)),
        **(F32_TOL if dtype == "float32" else BF16_TOL))

    agg = rb.block_fused_aggregate_plain(a, tu, tb, xt)
    assert agg.shape == (d,) and agg.dtype == torch.float32
    np.testing.assert_allclose(
        agg.numpy(), np.asarray(block_fused_aggregate_pallas(aj, tuj, tbj, xj, block_d=bd,
                                                             interpret=True)), **F32_TOL)

    w = rb.block_collapsed_weight_row(a, tu, tb)
    assert w.shape == (C, m)
    np.testing.assert_allclose(
        rb.block_row_stream_plain(w, xt).numpy(),
        np.asarray(block_row_stream_pallas(jnp.asarray(w.numpy()), xj, block_d=bd,
                                           interpret=True)), **F32_TOL)


def test_block_collapsed_weight_row_matches_reference_expression():
    Ab, tau_up, tau_b, _ = _block_inputs(3, 5, 1, seed=3)
    got = ops.block_collapsed_weight_row(*(torch.from_numpy(v) for v in (Ab, tau_up, tau_b)))
    want = np.einsum("ci,cij->cj", tau_up.astype(np.float64).reshape(3, 5),
                     Ab * np.swapaxes(tau_b, 1, 2)) / 15
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_block_kernels_at_one_cluster_are_the_dense_ones_bitwise():
    """C = 1: the blocked plain versions run the dense ones' arithmetic."""
    A, tau_up, tau_dd, X = (torch.from_numpy(a) for a in _round_inputs(10, 300, seed=4))
    A1, td1 = A[None], tau_dd[None]
    assert torch.equal(rb.block_fused_aggregate_plain(A1, tau_up, td1, X),
                       fa.fused_aggregate_plain(A, tau_up, tau_dd, X))
    w = ops.block_collapsed_weight_row(A1, tau_up, td1)
    assert torch.equal(w.reshape(-1), ops.collapsed_weight_row(A, tau_up, tau_dd))
    assert torch.equal(rb.block_row_stream_plain(w, X), fa.row_stream_plain(w.reshape(-1), X))
    assert torch.equal(rb.block_relay_mix_plain(A1, td1, X),
                       rm.relay_mix_plain(ops.mixing_mask(A, tau_dd), X))


def test_block_segments_equal_monolithic_bitwise():
    Ab, tau_up, tau_b, X = (torch.from_numpy(a) for a in _block_inputs(2, 5, 1000, seed=9))
    mono = ops.block_fused_aggregate(Ab, tau_up, tau_b, X)
    w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
    cuts = [0, 10, 11, 400, 1000]
    parts = [ops.block_row_stream(w, X[:, a:b].contiguous()) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), mono)


def test_block_ops_dispatch_cpu_takes_plain_version_without_launching():
    Ab, tau_up, tau_b, X = (torch.from_numpy(a) for a in _block_inputs(3, 5, 300, seed=5))
    wrappers = (rb.block_relay_mix_cuda, rb.block_fused_aggregate_cuda,
                rb.block_row_stream_cuda, rm.relay_mix_cuda)
    before = [f.launches for f in wrappers]
    for f in wrappers:
        f.launches = 0
    try:
        assert torch.equal(ops.block_relay_mix(Ab, tau_b, X),
                           rb.block_relay_mix_plain(Ab, tau_b, X))
        assert torch.equal(ops.block_fused_aggregate(Ab, tau_up, tau_b, X),
                           rb.block_fused_aggregate_plain(Ab, tau_up, tau_b, X))
        w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
        assert torch.equal(ops.block_row_stream(w, X), rb.block_row_stream_plain(w, X))
        mix = rb.block_mixing_mask(Ab, tau_b)[0]
        assert torch.equal(ops.relay_mix(mix, X[:5]), rm.relay_mix_plain(mix, X[:5]))
        assert [f.launches for f in wrappers] == [0, 0, 0, 0]
    finally:
        for f, b in zip(wrappers, before):
            f.launches = b


def test_block_cuda_wrappers_refuse_cpu_tensors():
    Ab, tau_up, tau_b, X = (torch.from_numpy(a) for a in _block_inputs(2, 4, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.block_relay_mix_cuda(Ab, tau_b, X)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.block_fused_aggregate_cuda(Ab, tau_up, tau_b, X)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.block_row_stream_cuda(tau_up.reshape(2, 4), X)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rm.relay_mix_cuda(Ab[0], X[:4])
    with pytest.raises(ValueError, match="n <= 110"):
        rm.relay_mix_cuda(torch.zeros(111, 111), torch.zeros(111, 4))
    with pytest.raises(ValueError, match="m <= 110"):
        rb.block_relay_mix_cuda(torch.zeros(1, 111, 111), torch.zeros(1, 111, 111),
                                torch.zeros(111, 4))


# -- kernel 9 over a round's segment list --------------------------------------

BLOCK_SEGMENT_CLUSTERINGS = [(2, 5), (3, 4)]  # C, m


@pytest.mark.parametrize("C,m", BLOCK_SEGMENT_CLUSTERINGS, ids=lambda v: str(v))
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_row_stream_segments_equal_per_segment_and_monolithic_bitwise(C, m, widths, dtype):
    """The grouped plain version of kernel 9 against the per-segment passes
    and kernel 8's plain version, through the CPU dispatch."""
    widths = SEGMENT_WIDTHS[widths]
    Ab, tau_up, tau_b, X = (torch.from_numpy(a)
                            for a in _block_inputs(C, m, sum(widths), seed=C * m + len(widths)))
    x = X.to(getattr(torch, dtype))
    segments = _segments_of(x, widths)
    w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
    got = ops.block_row_stream_segments(w, segments)
    assert got.shape == (sum(widths),) and got.dtype == torch.float32
    assert torch.equal(got, rb.block_row_stream_segments_plain(w, segments))
    assert torch.equal(got, torch.cat([ops.block_row_stream(w, s) for s in segments]))
    assert torch.equal(got, ops.block_fused_aggregate(Ab, tau_up, tau_b, x))


@pytest.mark.parametrize("C,m", BLOCK_SEGMENT_CLUSTERINGS, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_row_stream_segments_plain_matches_pallas(C, m, dtype):
    """Each segment of the grouped plain version against the reference's
    ``block_row_stream_pallas`` in interpret mode on that segment."""
    widths = (1, 10, 37)
    Ab, tau_up, tau_b, X = _block_inputs(C, m, sum(widths), seed=C * 10 + m)
    xj, xt = _stack(X, dtype)
    w = rb.block_collapsed_weight_row(*(torch.from_numpy(v) for v in (Ab, tau_up, tau_b)))
    got = rb.block_row_stream_segments_plain(w, _segments_of(xt, widths))
    off = 0
    for d in widths:
        want = block_row_stream_pallas(jnp.asarray(w.numpy()), xj[:, off:off + d], block_d=16,
                                       interpret=True)
        np.testing.assert_allclose(got[off:off + d].numpy(), np.asarray(want),
                                   **(F32_TOL if dtype == "float32" else BF16_TOL))
        off += d


@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_row_stream_segments_at_one_cluster_are_the_dense_grouped_ones_bitwise(widths,
                                                                                    dtype):
    widths = SEGMENT_WIDTHS[widths]
    A, tau_up, tau_dd, X = (torch.from_numpy(a)
                            for a in _round_inputs(10, sum(widths), seed=len(widths)))
    segments = _segments_of(X.to(getattr(torch, dtype)), widths)
    w = ops.collapsed_weight_row(A, tau_up, tau_dd)
    assert torch.equal(ops.block_row_stream_segments(w.reshape(1, 10), segments),
                       ops.row_stream_segments(w, segments))


def test_block_row_stream_segments_on_the_cpu_launch_nothing():
    wrappers = (rb.block_row_stream_cuda, rb.block_row_stream_segments_cuda,
                fa.row_stream_segments_cuda)
    before = [f.launches for f in wrappers]
    for f in wrappers:
        f.launches = 0
    try:
        Ab, tau_up, tau_b, X = (torch.from_numpy(a) for a in _block_inputs(2, 5, 4108, seed=6))
        w = ops.block_collapsed_weight_row(Ab, tau_up, tau_b)
        ops.block_row_stream_segments(w, _segments_of(X, SEGMENT_WIDTHS["off_grid"]))
        assert [f.launches for f in wrappers] == [0] * len(wrappers)
    finally:
        for f, b in zip(wrappers, before):
            f.launches = b


def test_block_row_stream_segments_cuda_refuses_what_the_kernel_does_not_take():
    """Checked before any card is touched: CPU tensors, mixed dtypes, a
    segment whose n differs, weight rows whose C*m is not the segments'
    n, and more segments than the kernel's parameter table holds; an n
    above the dense kernels' 4096 is taken (it reaches the device check)."""
    seg, w = torch.zeros(10, 16), torch.ones(2, 5)
    before = rb.block_row_stream_segments_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.block_row_stream_segments_cuda(w, [seg, seg])
    for other in (seg.to(torch.bfloat16), torch.zeros(12, 16)):
        with pytest.raises(ValueError, match="share the first one's device, dtype and n"):
            rb.block_row_stream_segments_cuda(w, [seg, other])
    with pytest.raises(ValueError, match=r"C\*m = 12 clients, the segments have n = 10"):
        rb.block_row_stream_segments_cuda(torch.ones(3, 4), [seg, seg])
    with pytest.raises(ValueError, match=r"\(C, m\) weight rows"):
        rb.block_row_stream_segments_cuda(torch.ones(10), [seg])
    for count in (0, fa.MAX_SEGMENTS + 1):
        with pytest.raises(ValueError, match=f"1 to {fa.MAX_SEGMENTS} segments"):
            rb.block_row_stream_segments_cuda(w, [seg] * count)
    big = torch.zeros(128 * 64, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.block_row_stream_segments_cuda(torch.ones(128, 64), [big, big])
    assert rb.block_row_stream_segments_cuda.launches == before


def test_build_compiles_and_binds_every_source_and_the_package_ships_them():
    """Every ``csrc/*.cu`` is compiled, every C entry point it exports has a
    ctypes signature, and the package data carries every source and header
    (``common.cuh`` was missing from it, so an installed package could not
    build its kernels)."""
    import pathlib
    import re
    import tomllib

    from repro_torch.kernels import build

    csrc = pathlib.Path(build.__file__).parent / "csrc"
    assert sorted(build.SOURCES) == sorted(csrc.glob("*.cu"))
    exported = {m for src in build.SOURCES
                for m in re.findall(r'extern "C" int (repro_\w+)', src.read_text())}
    assert exported == set(build._SIGNATURES)
    root = pathlib.Path(__file__).resolve().parent.parent
    globs = tomllib.loads((root / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["repro_torch"]
    pkg = csrc.parent.parent
    shipped = {p for g in globs for p in pkg.glob(g)}
    assert set(csrc.iterdir()) <= shipped, sorted(set(csrc.iterdir()) - shipped)

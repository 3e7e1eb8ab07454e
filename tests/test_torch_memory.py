"""The port's memory strategy and its kernels' plain versions against the
reference.

* The plain ``fused_memory_update`` / ``memory_stream`` against the
  reference's Pallas kernels run in interpret mode, on the same numpy
  inputs, n in {4, 10, 33}, f32 and bf16 stacks: atol 1e-5 (both widen
  bf16 exactly and accumulate in f32; they differ in summation order).
* Inside the port, segmented equals monolithic bitwise (the same
  operations in the same order on each column), and the grouped pass over
  a round's segment list equals both, writing the carried buffer in place.
* ``MemoryStrategy.aggregate`` against the reference's: atol 1e-5.
* With every link up the buffer is never read, and every memory path
  reduces to the port's colrel within 1e-6.

The port's memory functions overwrite the buffer they are given, so each
test hands them a clone of the state it compares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_segments import SEGMENT_WIDTHS
from repro import strategies as jstrategies
from repro.kernels.fused_memory import fused_memory_update_pallas, memory_stream_pallas
from repro.strategies.base import ExecutionContext as JExecutionContext
from repro_torch import strategies, tree
from repro_torch.kernels import fused_memory as fm
from repro_torch.kernels import ops
from repro_torch.strategies.base import ExecutionContext

ATOL = 1e-5


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) * 0.5 + 0.1).astype(np.float32)
    tau_up = (rng.random(n) < 0.6).astype(np.float32)
    tau_dd = (rng.random((n, n)) < 0.5).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.normal(size=(n, d)).astype(np.float32)
    return A, tau_up, tau_dd, X, B


def _stack(X, dtype):
    """The same values as a jax and a torch array of ``dtype``."""
    if dtype == "bfloat16":
        xj = jnp.asarray(X).astype(jnp.bfloat16)
        return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(X), torch.from_numpy(X)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("d", [1, 300, 2500])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_memory_update_plain_matches_pallas(n, d, dtype):
    A, tau_up, tau_dd, X, B = _inputs(n, d, seed=n * 11 + d)
    xj, xt = _stack(X, dtype)
    want_delta, want_buf = fused_memory_update_pallas(
        jnp.asarray(A), jnp.asarray(tau_up), jnp.asarray(tau_dd), xj, jnp.asarray(B),
        block_d=2048, interpret=True)
    buf = torch.from_numpy(B.copy())
    delta, out = fm.fused_memory_update_plain(*_t(A, tau_up, tau_dd), xt, buf)
    assert out is buf and delta.shape == (d,) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=ATOL, rtol=0)
    np.testing.assert_allclose(buf.numpy(), np.asarray(want_buf), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memory_stream_plain_matches_pallas(n, dtype):
    d = 700
    A, tau_up, tau_dd, X, B = _inputs(n, d, seed=n)
    mix = A * tau_dd.T
    xj, xt = _stack(X, dtype)
    want_delta, want_buf = memory_stream_pallas(
        jnp.asarray(mix), jnp.asarray(tau_up), xj, jnp.asarray(B), block_d=256,
        interpret=True)
    buf = torch.from_numpy(B.copy())
    delta, _ = fm.memory_stream_plain(torch.from_numpy(mix), torch.from_numpy(tau_up), xt, buf)
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=ATOL, rtol=0)
    np.testing.assert_allclose(buf.numpy(), np.asarray(want_buf), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [4, 10, 33])
def test_segments_write_the_monolithic_buffer_bitwise(n):
    d = 3001
    A, tau_up, tau_dd, X, B = _inputs(n, d, seed=2 * n)
    A, tau_up, tau_dd, X = _t(A, tau_up, tau_dd, X)
    mono_buf = torch.from_numpy(B.copy())
    mono, _ = ops.fused_memory_update(A, tau_up, tau_dd, X, mono_buf)
    mix = ops.mixing_mask(A, tau_dd)
    buf = torch.from_numpy(B.copy())
    cuts = [0, 1, 10, 1024, 2048, d]
    parts = [ops.memory_stream(mix, tau_up, X[:, a:b].contiguous(), buf[:, a:b])[0]
             for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), mono)
    assert torch.equal(buf, mono_buf)


@pytest.mark.parametrize("n", [4, 10, 33])
@pytest.mark.parametrize("widths", sorted(SEGMENT_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_segments_equal_per_segment_and_monolithic_bitwise(n, widths, dtype):
    """One grouped pass over the round's segment list against per-segment
    passes into column views and the monolithic update: delta and buffer
    bitwise; the grouped pass writes the buffer it was given in place."""
    widths = SEGMENT_WIDTHS[widths]
    A, tau_up, tau_dd, X, B = _t(*_inputs(n, sum(widths), seed=3 * n + len(widths)))
    X = X.to(dtype)
    mix = ops.mixing_mask(A, tau_dd)
    segments = [s.contiguous() for s in X.split(list(widths), dim=1)]
    buf = B.clone()
    ptr = buf.data_ptr()
    delta, out = ops.memory_stream_segments(mix, tau_up, segments, buf)
    assert out is buf and out.data_ptr() == ptr
    assert delta.shape == (sum(widths),) and delta.dtype == torch.float32
    seg_buf, parts, off = B.clone(), [], 0
    for s in segments:
        parts.append(ops.memory_stream(mix, tau_up, s, seg_buf[:, off:off + s.shape[1]])[0])
        off += s.shape[1]
    mono_buf = B.clone()
    mono, _ = ops.fused_memory_update(A, tau_up, tau_dd, X, mono_buf)
    assert torch.equal(delta, torch.cat(parts)) and torch.equal(buf, seg_buf)
    assert torch.equal(delta, mono) and torch.equal(buf, mono_buf)


def test_segmented_strategy_updates_the_carried_buffer_in_place():
    n = 10
    deltas = _as_torch(_deltas(n, seed=14))
    d = sum(x[0].numel() for x in tree.leaves(deltas))
    _, tau_up, tau_dd, _, B = _inputs(n, d, seed=15)
    A = np.abs(np.random.default_rng(16).normal(size=(n, n))).astype(np.float32)
    state = torch.from_numpy(B.copy())
    ptr = state.data_ptr()
    s = strategies.get("memory", fused="kernel")
    seg, new_state = s.aggregate_tree(deltas, *_t(tau_up, tau_dd, A), state,
                                      ExecutionContext(n_clients=n, segment_d=1))
    assert new_state is state and new_state.data_ptr() == ptr
    mono, mono_state = s.aggregate_tree(deltas, *_t(tau_up, tau_dd, A), torch.from_numpy(B.copy()),
                                        ExecutionContext(n_clients=n))
    assert torch.equal(new_state, mono_state)
    for a, b in zip(tree.leaves(seg), tree.leaves(mono)):
        assert torch.equal(a, b)


def _deltas(n, seed):
    rng = np.random.default_rng(seed)
    return {"conv": {"b": rng.normal(size=(n, 3)), "w": rng.normal(size=(n, 2, 2, 3, 5))},
            "fc": rng.normal(size=(n, 7, 4)), "s": rng.normal(size=(n,))}


def _as_torch(d):
    return tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), d)


def test_aggregate_matches_the_reference():
    n, d = 10, 400
    A, tau_up, tau_dd, X, B = _inputs(n, d, seed=5)
    want_delta, want_buf = jstrategies.get("memory").aggregate(
        jnp.asarray(X), jnp.asarray(tau_up), jnp.asarray(tau_dd), jnp.asarray(A), jnp.asarray(B))
    delta, buf = strategies.get("memory").aggregate(*_t(X, tau_up, tau_dd, A, B))
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=ATOL, rtol=0)
    np.testing.assert_allclose(buf.numpy(), np.asarray(want_buf), atol=ATOL, rtol=0)


@pytest.mark.parametrize("segment_d", [0, 1])
@pytest.mark.parametrize("fused", [False, "kernel"])
def test_aggregate_tree_matches_the_reference(fused, segment_d):
    """Tree path of every execution against the reference's faithful one;
    the carried buffer too."""
    n = 10
    raw = _deltas(n, seed=6)
    deltas = _as_torch(raw)
    d = sum(x[0].numel() for x in tree.leaves(deltas))
    _, tau_up, tau_dd, _, _ = _inputs(n, 1, seed=7)
    A = np.abs(np.random.default_rng(8).normal(size=(n, n))).astype(np.float32)
    B = np.random.default_rng(9).normal(size=(n, d)).astype(np.float32)
    jg, jbuf = jstrategies.get("memory").aggregate_tree(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), raw), jnp.asarray(tau_up),
        jnp.asarray(tau_dd), jnp.asarray(A), jnp.asarray(B), JExecutionContext(n_clients=n))
    ctx = ExecutionContext(n_clients=n, segment_d=segment_d)
    g, buf = strategies.get("memory", fused=fused).aggregate_tree(
        deltas, *_t(tau_up, tau_dd, A), torch.from_numpy(B.copy()), ctx)
    for got, want in zip(tree.leaves(g), jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf), atol=ATOL, rtol=0)


@pytest.mark.parametrize("segment_d", [0, 1])
@pytest.mark.parametrize("fused", [False, "kernel"])
def test_no_blockage_reduces_to_colrel(fused, segment_d):
    n = 10
    deltas = _as_torch(_deltas(n, seed=10))
    d = sum(x[0].numel() for x in tree.leaves(deltas))
    A = torch.from_numpy(np.abs(np.random.default_rng(11).normal(size=(n, n))).astype(np.float32))
    ones, full = torch.ones(n), torch.ones(n, n)
    ctx = ExecutionContext(n_clients=n, segment_d=segment_d)
    stale = torch.from_numpy(np.random.default_rng(12).normal(size=(n, d)).astype(np.float32))
    g, _ = strategies.get("memory", fused=fused).aggregate_tree(deltas, ones, full, A, stale, ctx)
    want, _ = strategies.get("colrel").aggregate_tree(deltas, ones, full, A, (), ctx)
    for a, b in zip(tree.leaves(g), tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_memory_options_and_state():
    with pytest.raises(ValueError, match="fused"):
        strategies.get("memory", fused="collapse")
    s = strategies.get("memory", fused="kernel")
    state = s.init_state(4, 9, device="cpu")
    assert state.shape == (4, 9) and state.dtype == torch.float32 and not state.any()
    assert s.needs_A and not s.scalar_collapsible
    assert s.weights(torch.ones(4), torch.ones(4, 4), torch.eye(4)) is None

"""The reduction of a traced segment to the per-layer metrics, on a
segment laid out by hand."""

import pytest

from benchlib import trace
from benchlib.registry import Registry
from benchlib.trace import Kernel, TraceView

MS = 1_000_000  # ns


def _view():
    # two chunks of 2 rounds: chunk 0's replays from 0 to 10 ms, chunk 1's
    # from 14 to 24 ms, the segment; a copy between them from 11 to 12 ms
    ks = [
        Kernel("nvjet_tst_128x64_gemm", 0, 3 * MS, 1, 0),
        Kernel("vectorized_elementwise_kernel", 3 * MS, 5 * MS, 1, 0),
        Kernel("void fused_aggregate_kernel<float, 4>", 5 * MS, 6 * MS, 1, 0),
        Kernel("nvjet_tst_128x64_gemm", 6 * MS, 10 * MS, 2, 0),
        Kernel("nvjet_tst_128x64_gemm", 14 * MS, 17 * MS, 3, 1),
        Kernel("vectorized_elementwise_kernel", 17 * MS, 19 * MS, 3, 1),
        Kernel("void fused_aggregate_kernel<float, 4>", 19 * MS, 20 * MS, 4, 1),
        Kernel("nvjet_tst_128x64_gemm", 20 * MS, 24 * MS, 4, 1),
        Kernel("copy_kernel", 12 * MS, 13 * MS, 9, None),
    ]
    copies = [("Memcpy HtoD (Pageable -> Device)", 11 * MS, 12 * MS)]
    device = [(k.start, k.end) for k in ks] + [(s, e) for _, s, e in copies]
    view = TraceView(kernels=sorted(ks, key=lambda k: k.start), device=device, copies=copies,
                     chunks=[(0, 10 * MS), (14 * MS, 24 * MS)],
                     host_ops=[("aten::copy_", 10 * MS, 12 * MS)], rounds=4, window=(0, 24 * MS))
    view.cell = {"device": "cuda", "n_clients": 2, "d": 1_000_000, "flops_per_round": 1e12,
                 "peak_flops": 1e15, "rounds_per_s": 10.0}
    view.stats = {"warmup_s": 1.0, "capture_s": 2.0, "instantiate_s": 0.5, "pool_bytes": 3e9}
    return view


@pytest.fixture
def read():
    reg = Registry()
    return lambda name: reg.module("metrics", name).read(_view())


def test_union_and_idle():
    assert trace.union_length([(0, 5), (3, 8), (10, 12)], (0, 20)) == 10
    assert trace.idle_intervals([(0, 5), (3, 8), (10, 12)], (0, 20)) == [(8, 10), (12, 20)]


def test_window_busy_and_idle(read):
    v = _view()
    assert v.window_s == pytest.approx(0.024)
    assert v.busy_s == pytest.approx(0.022)
    assert read("device_idle_pct") == pytest.approx(100 * 2 / 24)


def test_chunk_gap_is_replay_end_to_replay_start(read):
    assert read("chunk_gap_ms") == pytest.approx(4.0)


def test_kernel_classes(read):
    assert read("matmul_ms_per_round") == pytest.approx((3 + 4 + 3 + 4) / 4)
    assert read("pointwise_ms_per_round") == pytest.approx((2 + 2) / 4)


def test_agg_roofline_share(read):
    reg = Registry()
    least = reg.module("metrics", "agg_roofline_pct").least_seconds(2, 1_000_000)
    assert least == pytest.approx((8 * 4 + 8 + 8e6 + 4e6) / 3.35e12)
    assert read("agg_roofline_pct") == pytest.approx(100 * least / 1e-3)
    assert read("agg_roofline_pct") < 100


def test_counters_and_mfu(read):
    assert read("capture_s") == pytest.approx(3.5)
    assert read("graph_pool_gb") == pytest.approx(3.0)
    assert read("mfu") == pytest.approx(1.0)


def test_readers_find_nothing_in_an_empty_trace():
    reg = Registry()
    empty = TraceView(kernels=[], device=[], copies=[], chunks=[(0, 1)], host_ops=[], rounds=2,
                      window=(0, 1))
    empty.cell = {"device": "cpu"}
    for name in ("chunk_gap_ms", "matmul_ms_per_round", "pointwise_ms_per_round",
                 "agg_roofline_pct", "device_idle_pct", "mfu", "capture_s", "graph_pool_gb"):
        assert reg.module("metrics", name).read(empty) is None, name


def test_breakdown_names_gaps_by_span_and_host_op():
    b = trace.breakdown(_view())
    assert b["device_ops"][0][0] == "nvjet_tst_128x64_gemm"
    assert b["device_ops"][0][1] == pytest.approx(0.014)
    (name, secs), *_ = b["idle_gaps"]
    assert secs == pytest.approx(0.001)
    assert name == "between chunks / aten::copy_"
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10

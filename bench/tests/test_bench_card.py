"""A whole run of every cell on the card, short: it builds, replays, traces
and compares as the benchmark's own runs do.  Marked ``cuda``; skips
without a card."""

import pytest

from benchlib import driver

WORKLOADS = ["resnet20.fig2b.k4", "olmo1b.seq64.k2", "olmo1b.seq1024.k2"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(registry, cuda_device, workload, trace):
    import time

    out = driver.run_cell(registry, workload, seed=2**31 + 101, seconds=1.0, trace=trace,
                          t_start=time.perf_counter(), rehearse=False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    names = {m["name"] for m in registry.metrics(workload, "per_layer" if trace else "end_to_end")}
    assert set(out["metrics"]) == names
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        shares = [v["value"] for k, v in out["metrics"].items()
                  if k.split(".")[0] in ("agg_roofline_pct", "mfu")]
        assert len(shares) == 2 and all(0 < v <= 100 for v in shares), out["metrics"]

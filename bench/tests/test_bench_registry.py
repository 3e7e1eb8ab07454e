"""The harness is driven by data: a configuration, a traffic mix, a cell and a
per-layer metric dropped into a copy of the benchmark are found by name,
with no file of the harness edited."""

import json
import shutil

import pytest

from benchlib import driver
from benchlib.registry import BENCH, ROOT, Registry
from benchlib.trace import TraceView


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_cell_config_and_metric_are_found(copy):
    bench = copy / "bench"
    cfg = json.loads((bench / "configs" / "colrel-resnet20-cifar10.json").read_text())
    cfg["name"] = "colrel-resnet20-narrow"
    (bench / "configs" / "colrel-resnet20-narrow.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "static.k4.json").read_text())
    (bench / "traffic" / "static.k2.json").write_text(json.dumps(dict(traffic, chunk=2)))
    (bench / "workloads" / "resnet20.narrow.k2.json").write_text(
        (bench / "workloads" / "resnet20.fig2b.k4.json").read_text())
    (bench / "metrics" / "rounds_traced.py").write_text(
        "def read(view):\n    return float(view.rounds)\n")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "colrel-resnet20-narrow", "source": "https://arxiv.org/abs/2202.11850",
                            "file": "bench/configs/colrel-resnet20-narrow.json", "reduced": [],
                            "why": "a copy"})
    spec["workloads"].append({"name": "resnet20.narrow.k2", "config": "colrel-resnet20-narrow",
                              "traffic": "static.k2", "chips": 1, "why": "a copy"})
    spec["per_layer"].append({"name": "rounds_traced", "unit": "rounds", "better": "higher",
                              "source": "program_counter", "layer": "driver",
                              "moves": "rounds_per_s", "workloads": ["resnet20.narrow.k2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(bench)
    assert reg.cell("resnet20.narrow.k2")["traffic"] == "static.k2"
    assert reg.data("configs", "colrel-resnet20-narrow")["name"] == "colrel-resnet20-narrow"
    names = [m["name"] for m in reg.metrics("resnet20.narrow.k2", "per_layer")]
    assert names == ["rounds_traced"]
    assert "rounds_traced" not in [m["name"] for m in reg.metrics("resnet20.fig2b.k4", "per_layer")]
    view = TraceView(kernels=[], device=[], copies=[], chunks=[(0, 1)], host_ops=[], rounds=4,
                     window=(0, 1))
    assert reg.module("metrics", "rounds_traced").read(view) == 4.0
    # the new cell runs end to end through the copy, at its rehearsal sizes
    out = driver.run_cell(reg, "resnet20.narrow.k2", seed=5, seconds=0.0, trace=False,
                          t_start=0.0, rehearse=True)
    assert out["correct"] and out["attempted"] == 2


def test_every_entry_has_its_files(registry):
    spec = registry.benchmark()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert registry.data("configs", c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        registry.data("traffic", w["traffic"])
        assert set(registry.data("workloads", w["name"])["limits"]) == set(
            ("loss_gap", "delta_norm_gap", "momentum_gap", "change_gap"))
        cfg = registry.data("configs", w["config"])
        registry.module("families", cfg["family"])
        registry.module("reference", cfg["family"])
        registry.module("topologies", cfg["protocol"]["topology"]["kind"])
        traffic = registry.data("traffic", w["traffic"])
        registry.module("channels", traffic["channel"])
        registry.module("reference", traffic["round"]["reference"])
    for m in spec["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


def test_a_grouped_metric_is_read_by_its_quantitys_reader(copy):
    reg = Registry(copy / "bench")
    assert reg.reader("device_idle_pct.lm") is reg.module("metrics", "device_idle_pct")
    (copy / "bench" / "metrics" / "device_idle_pct.lm.py").write_text(
        "def read(view):\n    return 1.0\n")
    assert reg.reader("device_idle_pct.lm").read(None) == 1.0


def test_names_outside_the_rules_are_refused(registry):
    with pytest.raises(ValueError):
        registry.data("configs", "../BENCHMARK")

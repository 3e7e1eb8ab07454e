"""Everything the harness finds by name: the cell in ``BENCHMARK.json``, its
configuration, traffic and workload files, the per-layer metrics' readers,
and each family's program adapter and plain reference.

    bench/configs/<config>.json      sizes, protocol, topology, precision, peak
    bench/traffic/<traffic>.json     batch, sequence, chunk, channel law, round
    bench/workloads/<cell>.json      the limits that decide ``correct``
    bench/metrics/<metric>.py        read(view) -> float | None
    bench/families/<family>.py       the program's side of a family
    bench/reference/<name>.py        the plain reference of a family or a round
    bench/topologies/<kind>.py       links(topology) -> benchlib.links.Links
    bench/channels/<law>.py          the taus of every round, for both sides

A cell, a configuration, a channel law, a round or a metric is added as new
files and new entries; no file here names one.  A metric named
``<quantity>.<group>`` (the same quantity in a group of cells that report
another end-to-end metric) is read by ``metrics/<quantity>.py`` unless it
has a reader of its own.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "Registry"]

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


class Registry:
    """Lookups under one benchmark directory (``bench/`` and its root)."""

    def __init__(self, bench: pathlib.Path = BENCH, root: Optional[pathlib.Path] = None):
        self.bench = pathlib.Path(bench)
        self.root = pathlib.Path(root) if root is not None else self.bench.parent
        self._modules: Dict[str, ModuleType] = {}

    def benchmark(self) -> Dict[str, Any]:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> Dict[str, Any]:
        for w in self.benchmark()["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def data(self, kind: str, name: str) -> Dict[str, Any]:
        path = self.bench / kind / f"{_checked(name)}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        """``bench/<kind>/<name>.py``, loaded once."""
        path = self.bench / kind / f"{_checked(name)}.py"
        key = f"{kind}/{name}"
        if key not in self._modules:
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} module {path}")
            mod_name = "bench_" + re.sub(r"\W", "_", f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def reader(self, metric: str) -> ModuleType:
        """The reader of a per-layer metric: its own file, else that of the
        quantity before the first dot of its name."""
        if (self.bench / "metrics" / f"{_checked(metric)}.py").is_file():
            return self.module("metrics", metric)
        return self.module("metrics", metric.split(".")[0])

    def metrics(self, workload: str, section: str) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
        those that list it, and those without a list whose moved metric the
        cell reports."""
        bench = self.benchmark()
        e2e = [m for m in bench["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        if section == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]

"""What the benchmark may load: no module whose whole top-level name is
``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package) anywhere under
``bench/``, and nothing of the port in the plain references.  Names are
compared whole: ``repro_torch`` is not ``repro``."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from benchlib.driver import FORBIDDEN_MODULES, forbidden_loaded

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_under_bench(path):
    assert not set(_top_level_imports(path)) & set(FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert not set(_top_level_imports(path)) & set(FORBIDDEN_MODULES + ("repro_torch", "benchlib"))


def test_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert "repro_torch_lookalike" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.fl", types.ModuleType("repro.fl"))
    assert forbidden_loaded() == ["repro.fl"]


def test_run_loads_no_jax_in_its_process(tmp_path):
    """A rehearsal of a cell, and after it the process's modules, by name."""
    code = (
        "import runpy, sys, json\n"
        "sys.argv = ['bench/run.py', '--workload', 'olmo1b.seq64.k2', '--seed', '11', "
        "'--seconds', '0', '--rehearse']\n"
        "try:\n"
        "    runpy.run_path('bench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_MODULES!r})\n"
        "print('LOADED', json.dumps(bad))\n"
        "assert 'repro_torch' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'LOADED []' in out.stdout


def test_a_checkout_without_the_program_is_refused(tmp_path):
    (tmp_path / "bench").symlink_to(BENCH)
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, str(tmp_path / "bench" / "run.py"), "--workload",
                          "resnet20.fig2b.k4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

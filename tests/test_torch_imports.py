"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the reference package, and its entry
points run on CUDA unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.fl import experiment, trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_reference():
    bad = [(str(p.relative_to(ROOT)), m) for p in _port_files()
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
                     .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_need_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.build_experiment(experiment.ExperimentSpec(model="quadratic"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.resolve_device(None)
    assert trainer.resolve_device("cpu") == torch.device("cpu")

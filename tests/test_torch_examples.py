"""The port's examples (``examples/*_torch.py``) run on the CPU at tiny
settings, each in a process of its own, and the quickstart's numpy lines
(the uplink probabilities and COPT-alpha's variance reduction) equal the
reference example's."""

import json
import pathlib
import subprocess
import sys

import torch

from repro_torch import tree
from repro_torch.checkpoint import load_checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}


def _run(script, *flags, cwd=ROOT):
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *flags],
                         capture_output=True, text=True, env=ENV, cwd=cwd, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.splitlines()


def test_quickstart_runs_and_its_numpy_lines_equal_the_reference():
    flags = ("--rounds", "1", "--local-steps", "1")
    got = _run("quickstart_torch.py", "--device", "cpu", *flags)
    want = _run("quickstart.py", *flags)
    assert got[:2] == want[:2] and got[0].startswith("uplink probabilities: ")
    assert got[1].startswith("COPT-alpha: S ")
    assert got[2] == want[2]  # the model line: the same config, the same param count
    assert any(line.startswith("ColRel final loss ") for line in got)


def test_train_colrel_cifar_runs_and_saves(tmp_path):
    out = tmp_path / "cc"
    lines = _run("train_colrel_cifar_torch.py", "--device", "cpu", "--rounds", "1", "--out",
                 str(out))
    assert lines[0].startswith("COPT-alpha: S ") and lines[-1].startswith("final: ")
    log = json.loads((tmp_path / "cc.json").read_text())
    assert len(log["loss"]) == 1 and log["config"]["device"] == "cpu"
    params = load_checkpoint(tmp_path / "cc.pt")
    assert params and all(isinstance(x, torch.Tensor) for x in tree.leaves(params))


def test_serve_decode_runs():
    lines = _run("serve_decode_torch.py", "--device", "cpu", "--batch", "2", "--gen", "4",
                 "--prompt-len", "8")
    assert lines[0].startswith("serving gemma3-1b (reduced): ")
    assert lines[1].startswith("prefill: 8 tokens x 2 seqs in ")
    assert lines[2].startswith("decode:  3 steps in ")
    assert lines[3].startswith("  seq0: ...") and len(lines) == 5

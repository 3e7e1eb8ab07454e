"""The port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py``, ``tools/torch_kill_resume_smoke.py`` nor the
``examples/*_torch.py``, imports JAX or the reference package, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import InputShape, get_arch
from repro_torch.fl import experiment, trainer
from repro_torch.launch import dryrun, serve
from repro_torch.launch import train as train_cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = ("quickstart_torch.py", "train_colrel_cifar_torch.py", "serve_decode_torch.py")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "torch_kill_resume_smoke.py"] + [
        ROOT / "examples" / name for name in EXAMPLES]


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
    assert {"repro_torch.core.blocks", "repro_torch.channel.clustered",
            "repro_torch.kernels.relay_block", "repro_torch.kernels.relay_mix",
            "repro_torch.strategies.clustered", "repro_torch.models.attention",
            "repro_torch.models.mlp", "repro_torch.models.encdec", "repro_torch.models.registry",
            "repro_torch.configs.base", "repro_torch.configs.seamless_m4t_large_v2",
            "repro_torch.launch", "repro_torch.launch.steps", "repro_torch.launch.serve",
            "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
            "repro_torch.models.ssm", "repro_torch.models.mamba", "repro_torch.models.hybrid",
            "repro_torch.configs.jamba_1_5_large_398b", "repro_torch.telemetry.device",
            "repro_torch.telemetry.logger", "repro_torch.telemetry.manifest",
            "repro_torch.telemetry.timing", "repro_torch.ckpt.schema", "repro_torch.ckpt.writer",
            "repro_torch.ckpt.keys", "repro_torch.ckpt.preemption",
            "repro_torch.checkpoint.io", "repro_torch.models.transformer",
            "repro_torch.models.moe", "repro_torch.models.rwkv",
            "repro_torch.configs.olmo_1b", "repro_torch.configs.qwen3_0_6b",
            "repro_torch.configs.gemma3_1b", "repro_torch.configs.internvl2_2b",
            "repro_torch.configs.granite_moe_3b_a800m", "repro_torch.configs.rwkv6_1_6b",
            "repro_torch.configs.deepseek_coder_33b",
            "repro_torch.configs.dbrx_132b", "repro_torch.launch.train",
            "repro_torch.launch.specs", "repro_torch.optim.schedule",
            "repro_torch.optim.adam", "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.core.aggregation"} <= set(modules)
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve("seamless-m4t-large-v2", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    jamba = get_arch("jamba-1.5-large-398b").smoke().replace(moe_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve(cfg=jamba)
    for arch in ("olmo-1b", "granite-moe-3b-a800m", "rwkv6-1.6b", "internvl2-2b",
                 "jamba-1.5-large-398b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.serve(arch, smoke=True)
    for argv in (["--smoke", "--rounds", "1"], ["--smoke", "--arch", "rwkv6-1.6b", "--chunk", "2",
                                                "--rounds", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(argv)


def _example(name):
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"),
                                                  ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dry_run_needs_no_card_and_measure_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    step, specs = dryrun.prepare("qwen3-0.6b", InputShape("d", 16, 2, "decode"),
                                 cfg=get_arch("qwen3-0.6b").smoke())
    assert dryrun.trace(step, specs)["flops"] > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.measure(step, specs)
    assert dryrun.measure(step, specs, device="cpu")["device"] == "cpu"


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_cuda_unless_told_otherwise(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main()

"""The one-card dry run (``repro_torch.launch.{dryrun,roofline}``) against
the reference's dry run and against counts written from the configs.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its functions are read in a subprocess of their own; the
reference's record keys are read from its source with ``ast``.
"""

import ast
import json
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.launch.roofline import count_params_split as jcount_params_split
from repro.models import build as jbuild
from repro_torch.configs.base import CLI_ALIASES, INPUT_SHAPES, InputShape, get_arch, supported_shapes
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.specs import params_spec
from repro_torch.models import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
ARCHS = sorted(CLI_ALIASES)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_split_equals_the_reference_at_full_width(arch):
    cfg = get_arch(arch).full()
    got = roofline.count_params_split(params_spec(build(cfg)), cfg.n_experts, cfg.top_k)
    jcfg = jget_arch(arch).full()
    want = jcount_params_split(
        jax.eval_shape(lambda k: jbuild(jcfg).init(k), jax.random.PRNGKey(0)),
        jcfg.n_experts, jcfg.top_k)
    assert got == want


def test_tokens_depth_units_and_model_flops_equal_the_reference():
    code = """
import json
from repro.configs.base import CLI_ALIASES, INPUT_SHAPES, get_arch, supported_shapes
from repro.launch import dryrun
from repro.launch.roofline import model_flops
out = {}
for arch in sorted(CLI_ALIASES):
    cfg = get_arch(arch).full()
    for shape in supported_shapes(arch):
        for mode in (cfg.fl_mode, "weighted_grad"):
            kind = "train" if INPUT_SHAPES[shape].kind == "train" else "serve"
            tokens = dryrun._tokens_for(shape, mode)
            out[f"{arch}|{shape}|{mode}"] = [tokens, dryrun._depth_units(cfg),
                                             model_flops(kind, 1.25e9, tokens)]
print(json.dumps(out))
"""
    ref = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                    env=ENV, check=True, timeout=300).stdout)
    got = {}
    for arch in ARCHS:
        cfg = get_arch(arch).full()
        for shape in supported_shapes(arch):
            for mode in (cfg.fl_mode, "weighted_grad"):
                kind = "train" if INPUT_SHAPES[shape].kind == "train" else "serve"
                tokens = dryrun._tokens_for(shape, mode)
                got[f"{arch}|{shape}|{mode}"] = [tokens, dryrun._depth_units(cfg),
                                                 roofline.model_flops(kind, 1.25e9, tokens)]
    assert got == ref


def _reference_record_keys():
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "record" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record literal in the reference's dry run")


def test_record_has_the_reference_fields_plus_path():
    cfg = get_arch("qwen3-0.6b").smoke()
    rec = dryrun.run_one("qwen3-0.6b", "decode_32k", cfg=cfg)
    assert set(rec) == _reference_record_keys() | {"path"}
    assert rec["chips"] == 1 and rec["mesh"] == "1" and rec["path"] == "plain"
    assert rec["probe"] is None and rec["collective_bytes_per_chip"] == 0.0
    assert rec["collectives"] == {c: 0 for c in ("all-gather", "all-reduce", "reduce-scatter",
                                                 "all-to-all", "collective-permute")}
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                        "argument_bytes_global", "argument_bytes_per_shard"}
    assert mem["argument_bytes_global"] == mem["argument_bytes_per_shard"] == \
        mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] >= 0
    assert rec["roofline"]["collective_s"] == 0.0 and rec["hlo_flops_per_chip"] > 0


def test_prefill_flops_equal_the_plain_path_matmuls():
    """qwen3 at smoke(): q, k, v and o projections, the f32 attention logits
    and their product with v over the whole (T, T) square (the plain path
    masks, it does not skip), the SwiGLU MLP's three matmuls, and the LM
    head over every position."""
    cfg = get_arch("qwen3-0.6b").smoke()
    B, T = 2, 48
    step, specs = dryrun.prepare("qwen3-0.6b", InputShape("short", T, B, "prefill"), cfg=cfg)
    got = dryrun.trace(step, specs)["flops"]
    d, H, KV, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    N = B * T
    layer = (2 * N * d * hd * (H + 2 * KV) + 2 * N * H * hd * d
             + 2 * (2 * B * H * T * T * hd) + 3 * (2 * N * d * ff))
    assert got == cfg.n_layers * layer + 2 * N * d * cfg.vocab_size


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_trace_equals_the_step_on_real_cpu_tensors(kind):
    """The fake trace's FLOPs and peak equal ``measure`` on real CPU
    tensors (``MemTracker`` on both sides, the same allocations), exactly."""
    torch.manual_seed(0)
    cfg = get_arch("qwen3-0.6b").smoke()
    shape = {"train": InputShape("t", 32, 8, "train"), "prefill": InputShape("p", 64, 4, "prefill"),
             "decode": InputShape("d", 64, 4, "decode")}[kind]
    step, specs = dryrun.prepare("qwen3-0.6b", shape, n_clients=4, cfg=cfg)
    fake = dryrun.trace(step, specs)
    real = dryrun.measure(step, specs, device="cpu")
    assert real["finite"] and real["device"] == "cpu"
    assert fake["flops"] == real["flops"] > 0
    assert fake["peak_bytes"] == real["peak_bytes"] > fake["argument_bytes"] > 0


def test_mesh_other_than_single_exits_2(tmp_path, capsys):
    for mesh in ("multi", "both"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "qwen3-0.6b", "--mesh", mesh, "--out", str(tmp_path)])
        assert e.value.code == 2
        assert "one device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_cli_writes_a_full_width_decode_record(tmp_path):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
                          "--shape", "decode_32k", "--out", str(tmp_path)],
                         capture_output=True, text=True, env=ENV, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DRY-RUN SUMMARY: 1 ok, 0 failed" in out.stdout
    rec = json.loads((tmp_path / "olmo-1b_decode_32k_1_colrel.json").read_text())
    cfg = get_arch("olmo-1b").full()
    assert rec["arch"] == "olmo-1b" and rec["shape"] == "decode_32k" and rec["chips"] == 1
    assert rec["path"] == "plain" and rec["params_total"] == rec["params_active"]
    shape = INPUT_SHAPES["decode_32k"]
    cache = 2 * cfg.n_layers * shape.global_batch * shape.seq_len * cfg.n_kv_heads * cfg.hd * 2
    assert rec["memory_analysis"]["argument_size_in_bytes"] >= cache
    assert rec["model_flops_per_chip"] == 2.0 * rec["params_active"] * shape.global_batch

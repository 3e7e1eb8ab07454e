"""The dry run (``repro_torch.launch.{dryrun,roofline}``) against the
reference's dry run and against counts written from the configs: on one
card, and on the reference's meshes traced on a fake process group.

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


@pytest.mark.parametrize("mesh", ["card", "single"])
def test_by_op_splits_the_flops(mesh):
    """``by_op`` (``--by-op``) adds ``flops_by_op`` to the record: the
    per-device FLOPs of each aten op, which sum to the record's."""
    cfg = get_arch("qwen3-0.6b").smoke()
    rec = dryrun.run_one("qwen3-0.6b", "decode_32k", mesh=mesh, cfg=cfg, by_op=True)
    assert set(rec) == _reference_record_keys() | {"path", "flops_by_op"}
    assert set(rec["flops_by_op"]) <= {"aten.mm", "aten.bmm", "aten.addmm"}
    assert sum(rec["flops_by_op"].values()) == rec["hlo_flops_per_chip"] > 0


@pytest.mark.parametrize("mesh", ["multi", "card"])
def test_mesh_option_writes_its_record(mesh, tmp_path):
    """``--mesh multi`` traces rank 0 of the 2 x 16 x 16 mesh on a fake
    group (512 devices, 32 clients, per-device counts a 512th of the
    card's); ``--mesh card`` writes the one-device record."""
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", mesh,
                        "--out", str(tmp_path)]) == 0
    tag = {"multi": "2x16x16", "card": "1"}[mesh]
    rec = json.loads((tmp_path / f"qwen3-0.6b_decode_32k_{tag}_colrel.json").read_text())
    assert set(rec) == _reference_record_keys() | {"path"} and rec["mesh"] == tag
    mem = rec["memory_analysis"]
    shape = INPUT_SHAPES["decode_32k"]
    if mesh == "card":
        assert rec["chips"] == 1 and rec["n_clients"] == 16
        assert rec["collective_bytes_per_chip"] == 0.0 and rec["roofline"]["collective_s"] == 0.0
        assert mem["argument_bytes_global"] == mem["argument_bytes_per_shard"]
    else:
        assert rec["chips"] == 512 and rec["n_clients"] == 32
        assert rec["collective_bytes_per_chip"] == sum(rec["collectives"].values()) > 0
        assert rec["roofline"]["collective_s"] == rec["collective_bytes_per_chip"] / 50e9
        # the cache is the arguments' bulk: batch over 32 clients, sequence
        # over 16 (8 kv heads do not divide the model axis)
        assert mem["argument_bytes_per_shard"] < mem["argument_bytes_global"] / 256
    assert rec["model_flops_per_chip"] == \
        2.0 * rec["params_active"] * shape.global_batch / rec["chips"]
    assert rec["hlo_flops_per_chip"] > 0 and rec["path"] == "plain"


def test_counts_are_per_device_on_a_fake_mesh():
    """A ``Shard(1)`` matmul on a fake (4,) mesh: :class:`StepCounter` counts
    a quarter of its global FLOPs (``FlopCounterMode`` counts the DTensor op
    at its global shapes) and the output bytes of the all-gather that
    replicates the product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        with FakeTensorMode():  # the mesh is built outside it
            a = DTensor.from_local(torch.empty(64, 256), mesh, [Replicate()])
            b = DTensor.from_local(torch.empty(256, 128), mesh, [Shard(1)])
            a @ b  # DTensor caches the product's sharding first
            with dryrun.StepCounter() as counter, FlopCounterMode(display=False) as whole:
                y = (a @ b).redistribute(mesh, [Replicate()])
        assert tuple(y.shape) == (64, 512)
    assert whole.get_total_flops() == 2 * 64 * 256 * 512
    assert counter.flops == 2 * 64 * 256 * 512 // 4
    assert counter.collectives == {"all-gather": 64 * 512 * 4, "all-reduce": 0,
                                   "reduce-scatter": 0, "all-to-all": 0,
                                   "collective-permute": 0}


def test_one_by_one_mesh_trace_equals_the_one_device_trace():
    """qwen3 at smoke(): rank 0 of a fake 1 x 1 mesh does the one device's
    work, so its trace has the same FLOPs, and its peak is within 0.1%
    (the DTensor wrappers hold no storage), for each step kind."""
    from repro_torch.dist import make_debug_mesh

    cfg = get_arch("qwen3-0.6b").smoke()
    for shape in (InputShape("t", 32, 4, "train"), InputShape("p", 64, 2, "prefill"),
                  InputShape("d", 64, 2, "decode")):
        step, specs = dryrun.prepare("qwen3-0.6b", shape, n_clients=1, cfg=cfg)
        one = dryrun.trace(step, specs)
        with dryrun.fake_group(1):
            mstep, args, in_sh = dryrun.prepare_mesh("qwen3-0.6b", shape,
                                                     make_debug_mesh(1, 1, device_type="cpu"),
                                                     cfg=cfg)
            got = dryrun.trace_mesh(mstep, args, in_sh)
        assert got["flops"] == one["flops"] > 0, shape.kind
        assert abs(got["peak_bytes"] - one["peak_bytes"]) <= 1e-3 * one["peak_bytes"], shape.kind
        assert got["collectives"] == {c: 0 for c in dryrun.COLLECTIVES}
        assert got["argument_bytes"] == got["argument_bytes_global"] == one["argument_bytes"]


def test_cli_writes_a_full_width_decode_record(tmp_path):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
                          "--shape", "decode_32k", "--mesh", "card", "--out", str(tmp_path)],
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

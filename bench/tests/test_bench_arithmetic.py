"""The harness's arithmetic of operations and parameters against hand counts,
and once against the port's own dry-run counter."""

import pytest
import torch

from benchlib import hw


def _config(registry, name):
    return registry.data("configs", name)


def test_resnet20_macs_by_hand(registry):
    fam = registry.module("families", "resnet_gn")
    cfg = _config(registry, "colrel-resnet20-cifar10")
    # stem 32*32*16*27; stage 1: 6 convs of 32*32*16*144; stages 2 and 3: a
    # stride-2 conv, its 1x1 projection and 5 convs at the halved resolution
    stage = 1_179_648 + 131_072 + 5 * 2_359_296
    assert fam.macs_per_image(cfg["model"]) == 442_368 + 6 * 2_359_296 + 2 * stage + 640
    assert fam.macs_per_image(cfg["model"]) == 40_813_184
    assert fam.n_params(cfg) == 272_282
    assert fam.flops_per_round(cfg, {}) == pytest.approx(6 * 40_813_184 * 64 * 8 * 10)


def test_olmo_params_and_flops_by_hand(registry):
    fam = registry.module("families", "olmo")
    cfg = _config(registry, "colrel-olmo-1b-8l")
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 8192
    assert fam.n_params(cfg) == 50304 * 2048 + 8 * per_layer == 639_893_504
    for name, tokens in (("seq64.b4.k2", 8 * 4 * 4 * 64), ("seq1024.b4.k2", 8 * 4 * 4 * 1024)):
        traffic = registry.data("traffic", name)
        assert fam.flops_per_round(cfg, traffic) == 6 * 639_893_504 * tokens


def test_resnet20_macs_against_the_dry_run_counter(registry):
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.models.cnn import CNN, CNNConfig

    fam = registry.module("families", "resnet_gn")
    model = CNN(CNNConfig())
    counter = StepCounter()
    with torch.no_grad(), counter:
        model(torch.zeros(1, 32, 32, 3))
    assert counter.flops == 2 * fam.macs_per_image(_config(registry, "colrel-resnet20-cifar10")["model"])


def test_olmo_params_against_the_port(registry):
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.specs import params_spec
    from repro_torch.models import build, count_params

    fam = registry.module("families", "olmo")
    cfg = _config(registry, "colrel-olmo-1b-8l")
    port = get_arch("olmo-1b").full().replace(n_layers=8, tie_embeddings=True)
    assert count_params(params_spec(build(port))) == fam.n_params(cfg)
    # the file's widths are the port's preset's
    m = cfg["model"]
    assert (port.d_model, port.n_heads, port.n_kv_heads, port.hd, port.d_ff, port.vocab_size,
            port.rope_theta, port.dtype) == (
        m["hidden_size"], m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"],
        m["intermediate_size"], m["vocab_size"], m["rope_theta"], m["torch_dtype"])


def test_olmo_step_flops_against_the_dry_run_counter(registry):
    """One client step (loss and gradient) of 8 tokens at full width on fake
    tensors: the counted FLOPs are 6 N D within the attention's share."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import tree
    from repro_torch.launch.dryrun import StepCounter

    fam = registry.module("families", "olmo")
    cfg = _config(registry, "colrel-olmo-1b-8l")
    loss_fn, tree_of = fam.program(cfg, torch.device("cpu"))
    with FakeTensorMode():
        flat = {k: torch.empty(s, dtype=torch.bfloat16) for k, s in fam.param_shapes(cfg["model"])}
        params = tree.map(lambda x: x.requires_grad_(), tree_of(flat))
        batch = {"tokens": torch.zeros(1, 8, dtype=torch.long),
                 "labels": torch.zeros(1, 8, dtype=torch.long)}
        counter = StepCounter()
        with counter:
            loss, _ = loss_fn(params, batch)
            torch.autograd.grad(loss, tree.leaves(params))
    assert counter.flops == pytest.approx(6 * fam.n_params(cfg) * 8, rel=5e-3)


def test_peaks_are_the_data_sheets():
    assert hw.peak_flops("tf32") == 495e12 and hw.peak_flops("bf16") == 989e12
    assert hw.HBM_BYTES_PER_S == 3.35e12
    with pytest.raises(KeyError):
        hw.peak_flops("int4")

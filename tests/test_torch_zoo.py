"""The rest of the model zoo in the port against live runs of the
reference, on the CPU: the eight decoder-only configs (dense olmo-1b,
qwen3-0.6b, gemma3-1b and deepseek-coder-33b; MoE granite-moe-3b-a800m
and dbrx-132b; RWKV6 rwkv6-1.6b; the VLM internvl2-2b) and jamba with its
MoE positions.

Each model runs at its ``smoke()`` config (2 layers, d_model 128, f32; jamba
one period of 4 layers); the port is fed the reference's own params
(``params_from_jax``) and the same numpy inputs.  Tolerance, as
``max|got - want| <= tol * max(1, max|want|)``: ``ATTN_TOL = 1e-4`` for
everything that goes through attention or RWKV's recurrence, as
``tests/test_torch_hybrid.py`` holds jamba (the zoo's init makes the
softmaxes nearly one-hot, and a one-ulp difference in a projection moves
the small weights; measured up to ~4e-5 of the scale, on granite's MoE
forward).  The init trees are compared exactly: key paths, shapes and
dtypes, at ``full()`` too (the port's on fake tensors, the reference's
through ``jax.eval_shape``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as jbase
from repro.models import build as jbuild
from repro.models import transformer as jtr
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import build_step
from repro_torch.models import attention, build, count_params, hybrid, transformer

ATTN_TOL = 1e-4
ARCHS = ["olmo-1b", "qwen3-0.6b", "gemma3-1b", "internvl2-2b", "granite-moe-3b-a800m",
         "rwkv6-1.6b", "deepseek-coder-33b", "dbrx-132b"]
JAMBA = "jamba-1.5-large-398b"
B, T = 2, 32


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


class _Model:
    """A smoke config in both packages, the reference's params in both, and
    the reference's jitted entry points."""

    def __init__(self, arch, **overrides):
        self.jcfg = jbase.get_arch(arch).smoke().replace(**overrides)
        self.cfg = base.get_arch(arch).smoke().replace(**overrides)
        self.jb, self.b = jbuild(self.jcfg), build(self.cfg)
        self.jparams = self.jb.init(jax.random.PRNGKey(0))
        self.params = params_from_jax(jax.tree.map(np.asarray, self.jparams), "cpu")
        self.jforward = jax.jit(self.jb.forward)
        self.jloss = jax.jit(self.jb.loss_fn)
        self.jdecode = jax.jit(self.jb.decode_step)

    def inputs(self, seed, t=T, prefix=True):
        """numpy tokens (and a VLM's patches) -> (reference batch, port batch)."""
        rng = np.random.default_rng(seed)
        tok = rng.integers(0, self.cfg.vocab_size, size=(B, t)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok).long()}
        if prefix and self.cfg.frontend_tokens:
            pre = rng.normal(size=(B, self.cfg.frontend_tokens, self.cfg.d_model))
            jb["prefix"], tb["prefix"] = jnp.asarray(pre, jnp.float32), torch.from_numpy(
                pre.astype(np.float32))
        return jb, tb


@pytest.fixture(scope="module")
def models():
    """arch -> its :class:`_Model`, each built once for the module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Model(arch)
        return cache[arch]

    return get


@pytest.fixture
def flash_calls(monkeypatch):
    """Calls of the flash-attention entry point the models reach."""
    calls = []
    real = kops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kops, "flash_attention", counting)
    return calls


# ---------------------------------------------------------------------------
# configs, registry, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    mod, jmod = base.get_arch(arch), jbase.get_arch(arch)
    for which in ("full", "smoke"):
        assert dataclasses.asdict(getattr(mod, which)()) == dataclasses.asdict(
            getattr(jmod, which)()), which
    assert mod.SHAPES == jmod.SHAPES and base.supported_shapes(arch) == jbase.supported_shapes(
        arch)
    assert base.get_arch(base.CLI_ALIASES[arch]) is mod
    if arch == "internvl2-2b":
        assert mod.VISION_PATCHES == jmod.VISION_PATCHES == mod.full().frontend_tokens == 1024


def _port_tree(cfg, monkeypatch, fake):
    if not fake:
        return build(cfg).init(torch.Generator().manual_seed(0))
    # shapes and dtypes only: fake tensors, on which trunc_normal_'s
    # data-dependent resampling loop cannot run, so it is made a no-op
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", lambda t, *a, **kw: t)
    with FakeTensorMode():
        return build(cfg).init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS + [JAMBA])
def test_init_tree_matches_reference(arch, which, monkeypatch):
    jcfg = getattr(jbase.get_arch(arch), which)()
    cfg = getattr(base.get_arch(arch), which)()
    want = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    got = _port_tree(cfg, monkeypatch, fake=which == "full")
    jpaths = [".".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert tree.paths(got) == jpaths
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in tree.leaves(got)] == [
        (w.shape, str(w.dtype)) for w in jax.tree.leaves(want)]
    assert count_params(got) == sum(int(np.prod(w.shape)) for w in jax.tree.leaves(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_window_array_matches_reference(arch):
    for cfg in (base.get_arch(arch).full(), base.get_arch(arch).smoke()):
        assert transformer.window_array(cfg) == np.asarray(jtr.window_array(cfg)).tolist()
    assert transformer.GLOBAL_WINDOW == jtr.GLOBAL_WINDOW
    if arch == "gemma3-1b":
        full = base.get_arch(arch).full()
        assert transformer.window_array(full)[:6] == [512] * 5 + [transformer.GLOBAL_WINDOW]


# ---------------------------------------------------------------------------
# forward, loss, decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_and_use_flash_is_inert(arch, models, flash_calls):
    m = models(arch)
    jb, tb = m.inputs(seed=1)
    want = m.jforward(m.jparams, jb)
    plain = m.b.forward(m.params, tb, use_flash=False)
    flash = m.b.forward(m.params, tb, use_flash=True)
    P = m.cfg.frontend_tokens
    assert plain.shape == (B, P + T, m.cfg.vocab_size)
    _close(plain, want, ATTN_TOL)
    assert torch.equal(flash, plain) and not flash_calls
    if arch != "rwkv6-1.6b":  # the counter sees a flash call where one is taken
        lp = tree.map(lambda x: x[0], m.params["layers"])["attn"]
        attention.attention(m.cfg, lp, torch.zeros(B, 16, m.cfg.d_model), use_flash=True)
        assert len(flash_calls) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, models):
    """Masked labels (negative), the MoE aux, a VLM's prefix; and the
    per-sequence ``ce_weight``."""
    m = models(arch)
    jb, tb = m.inputs(seed=2)
    labels = np.roll(np.asarray(jb["tokens"]), -1, axis=1)
    labels[:, -3:] = -1
    labels[0, :2] = -1
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    for weighted in (False, True):
        if weighted:
            w = np.array([0.3, 0.7], np.float32)
            jb["ce_weight"], tb["ce_weight"] = jnp.asarray(w), torch.from_numpy(w)
        jl, jm = m.jloss(m.jparams, jb)
        loss, metrics = m.b.loss_fn(m.params, tb)
        _close(loss, jl, ATTN_TOL)
        _close(metrics["ce"], jm["ce"], ATTN_TOL)
        _close(metrics["moe_aux"], jm["moe_aux"], ATTN_TOL)
        assert (float(metrics["moe_aux"]) > 0) == (m.cfg.n_experts > 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_over_a_replayed_prompt_matches_reference(arch, models):
    m = models(arch)
    tok = np.array(m.inputs(seed=4, t=16)[0]["tokens"])
    jcache, cache = m.jb.init_cache(B, 24), m.b.init_cache(B, 24)
    assert tree.paths(cache) == tree.paths(
        params_from_jax(jax.tree.map(np.asarray, jcache), "cpu"))
    for t in range(tok.shape[1]):
        jl, jcache = m.jdecode(m.jparams, jcache, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        logits, out = m.b.decode_step(m.params, cache, torch.from_numpy(tok[:, t:t + 1]).long(),
                                      t)
        assert out is cache  # written in place
        _close(logits, jl, ATTN_TOL)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(jcache)):
        _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_the_replayed_prompt(arch, models):
    """``tests/test_decode_consistency.py``'s check in the port (a VLM's
    text alone: its decode step has no prefix), 1e-4 in f32."""
    m = models(arch)
    tok = m.inputs(seed=6, t=64, prefix=False)[1]["tokens"]
    pre = build_step(m.b, "prefill")(m.params, {"tokens": tok})
    step, cache = build_step(m.b, "decode"), m.b.init_cache(B, 64)
    for t in range(64):
        last, cache = step(m.params, cache, tok[:, t:t + 1], t)
    _close(last, pre.numpy(), ATTN_TOL)


def test_rwkv_cache_holds_each_layers_own_state(models):
    m = models("rwkv6-1.6b")
    cache = m.b.init_cache(B, 8)
    assert all(x.shape[0] == m.cfg.n_layers and x.is_contiguous() for x in tree.leaves(cache))
    tok = m.inputs(seed=7)[1]["tokens"]
    m.b.decode_step(m.params, cache, tok[:, :1], 0)
    for x in tree.leaves(cache):
        assert float(x[0].abs().max()) > 0 and not torch.equal(x[0], x[1])


def test_gemma3_static_window_pattern_matches_reference():
    """The unrolled stack: the local layer banded (T > attn_chunk), the
    global one dense, against the reference's and the port's scanned path."""
    m = _Model("gemma3-1b", static_window_pattern=True, attn_chunk=16)
    jb, tb = m.inputs(seed=8, t=64)
    got = m.b.forward(m.params, tb)
    _close(got, m.jforward(m.jparams, jb), ATTN_TOL)
    scanned = build(m.cfg.replace(static_window_pattern=False)).forward(m.params, tb)
    _close(got, scanned.numpy(), ATTN_TOL)


# ---------------------------------------------------------------------------
# jamba with its MoE positions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jamba():
    return _Model(JAMBA)


@pytest.mark.parametrize("use_flash", [False, True])
def test_jamba_with_experts_forward_matches_reference(jamba, use_flash):
    m = jamba
    assert hybrid._pattern(m.cfg)[3] == [1, 3]  # moe_every=2: the odd positions
    assert sorted(m.params["periods"]["ffns"]["l1"]) == ["router", "wd", "wg", "wu"]
    jb, tb = m.inputs(seed=1, t=64)
    want = jax.jit(m.jb.forward, static_argnames="use_flash")(m.jparams, jb, use_flash=use_flash)
    logits, aux = hybrid.forward(m.cfg, m.params, tb["tokens"], use_flash=use_flash)
    _close(logits, want, ATTN_TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0


def test_jamba_with_experts_loss_and_decode_match_reference(jamba):
    m = jamba
    jb, tb = m.inputs(seed=2)
    labels = np.roll(np.asarray(jb["tokens"]), -1, axis=1)
    labels[:, -2:] = -1
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    jl, jm = m.jloss(m.jparams, jb)
    loss, metrics = m.b.loss_fn(m.params, tb)
    _close(loss, jl, ATTN_TOL)
    _close(metrics["moe_aux"], jm["moe_aux"], ATTN_TOL)
    assert float(loss - metrics["ce"]) == pytest.approx(
        m.cfg.router_aux_coef * float(metrics["moe_aux"]), rel=1e-5)
    tok = np.array(jb["tokens"])[:, :16]
    jcache, cache = m.jb.init_cache(B, 16), m.b.init_cache(B, 16)
    for t in range(16):
        jlog, jcache = m.jdecode(m.jparams, jcache, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        logits, _ = m.b.decode_step(m.params, cache, torch.from_numpy(tok[:, t:t + 1]).long(), t)
        _close(logits, jlog, ATTN_TOL)
    pre = build_step(m.b, "prefill")(m.params, {"tokens": torch.from_numpy(tok).long()})
    _close(logits, pre.numpy(), ATTN_TOL)


# ---------------------------------------------------------------------------
# the serving CLI, one model of each family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "internvl2-2b", JAMBA])
def test_serve_runs_each_family_end_to_end_on_the_cpu(arch):
    lines = []
    res = serve_mod.serve(arch, smoke=True, batch=2, prompt_len=32, gen=4, device="cpu", seed=3,
                          log=lines.append)
    cfg = base.get_arch(arch).smoke()
    assert res.prompts.shape == (2, 32) and res.tokens.shape == (2, 4) and res.decode_steps == 3
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size
    assert torch.equal(res.tokens[:, 0], torch.argmax(res.replay_logits, -1))
    if cfg.arch_type == "vlm":  # patches in the prefill only
        assert res.frames.shape == (2, cfg.frontend_tokens, cfg.d_model)
        assert any(f"{cfg.frontend_tokens} patches" in line for line in lines)
        assert float((res.prefill_logits - res.replay_logits).abs().max()) > 1e-3
        params = build(cfg).init(torch.Generator().manual_seed(3))
        text_only = build_step(build(cfg), "prefill")(params, {"tokens": res.prompts})
        _close(res.replay_logits, text_only.numpy(), ATTN_TOL)
    else:
        assert res.frames is None
        _close(res.replay_logits, res.prefill_logits.numpy(), ATTN_TOL)
    if arch == JAMBA:  # the CLI, with the MoE positions
        assert serve_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "1",
                               "--prompt-len", "16", "--gen", "2"]) == 0

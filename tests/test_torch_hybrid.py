"""jamba-1.5-large-398b without experts (the Mamba/attention hybrid) in the
port against a live run of the reference, on the CPU.

The config is ``smoke().replace(moe_every=0)``: one period of 4 layers
(1 attention, 3 Mamba, dense SwiGLU MLPs), d_model 128, f32.  The port is
fed the reference's own params (``params_from_jax``, which takes the
stacked-period tree as it is) and the same numpy inputs.  Tolerances, as
``max|got - want| <= tol * max(1, max|want|)``:

* ``TOL = 1e-5`` for the Mamba layer, its decode step and its state:
  f32 on both sides, sums in another order.
* ``ATTN_TOL = 1e-4`` for anything that goes through attention (the
  forward, the decode step, the loss), as ``tests/test_torch_encdec.py``
  holds seamless: the zoo's init makes the softmaxes nearly one-hot, and
  a one-ulp difference in a projection moves the small weights.  Measured
  ~7e-6 for the forward at T=128, flash and plain alike.

On the CPU the Mamba prefill takes ``ssd_scan``'s plain version; the
reference's takes its jnp ``ssd_chunked``, and its flash path runs the
Pallas kernel in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import build_step
from repro_torch.models import build, count_params
from repro_torch.models import hybrid
from repro_torch.models import mamba

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5
ATTN_TOL = 1e-4
B, T = 2, 128


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


def _to_port(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, port cfg, reference params, the same params in the port)."""
    jcfg = jbase.get_arch(ARCH).smoke().replace(moe_every=0)
    cfg = base.get_arch(ARCH).smoke().replace(moe_every=0)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _to_port(jparams)


def _tokens(cfg, seed, t=T):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, registry, init
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    for which in ("full", "smoke"):
        got = dataclasses.asdict(getattr(base.get_arch(ARCH), which)())
        want = dataclasses.asdict(getattr(jbase.get_arch(ARCH), which)())
        assert got == want, which
    assert base.get_arch("jamba_1_5_large_398b").SHAPES == jbase.get_arch(ARCH).SHAPES
    assert base.supported_shapes(ARCH) == jbase.supported_shapes(ARCH)
    full = base.get_arch(ARCH).full().replace(moe_every=0)
    assert (full.hd, full.d_inner, full.n_ssm_heads, full.tdtype) == (128, 16384, 256,
                                                                       torch.bfloat16)
    assert hybrid.n_periods(full) == 9 and hybrid.n_periods(full.replace(n_layers=8)) == 1


def test_moe_positions_raise_naming_the_roadmap_item():
    """The MoE positions are ported: smoke() and full() build with a MoE
    MLP at every odd position of the period (``tests/test_torch_zoo.py``
    holds them to the reference); a ragged period still raises."""
    for cfg in (base.get_arch(ARCH).smoke(), base.get_arch(ARCH).full()):
        period, attn_pos, mamba_pos, moe_pos = hybrid._pattern(cfg)
        assert moe_pos == list(range(1, period, 2)) and attn_pos == [0]
        assert build(cfg).decode_step is not None
    params = build(base.get_arch(ARCH).smoke()).init(torch.Generator().manual_seed(0))
    E = base.get_arch(ARCH).smoke().n_experts
    assert params["periods"]["ffns"]["l1"]["wg"].shape[1] == E  # (periods, E, d, f)
    assert sorted(params["periods"]["ffns"]["l0"]) == ["wd", "wg", "wu"]
    res = serve_mod.serve(ARCH, smoke=True, batch=1, prompt_len=16, gen=2, device="cpu", log=None)
    assert res.tokens.shape == (1, 2)
    with pytest.raises(ValueError, match="whole number of periods"):
        build(base.get_arch(ARCH).smoke().replace(moe_every=0, n_layers=6))


def test_init_has_the_reference_tree_shapes_and_scales(smoke):
    jcfg, cfg, jparams, ported = smoke
    params = build(cfg).init(torch.Generator().manual_seed(0))
    assert tree.paths(params) == tree.paths(ported)
    for got, want in zip(tree.leaves(params), jax.tree.leaves(jparams)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert all(x.shape[0] == 1 for x in tree.leaves(params["periods"]))  # one stacked period
    assert count_params(params) == jcommon.count_params(jparams)
    m, jm = params["periods"]["mixers"]["l1"], jparams["periods"]["mixers"]["l1"]
    for key in ("A_log", "D", "conv_b", "norm_scale"):  # deterministic in both packages
        _close(m[key], jm[key], 0.0)
    # dt_bias is softplus^-1 of dt, dt log-uniform in [1e-3, 1]
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1 + 1e-5
    std = 1 / np.sqrt(cfg.d_model)
    assert float(m["w_in"].abs().max()) <= 2 * std * (1 + 1e-6)
    assert abs(float(m["conv_w"].std()) - float(np.asarray(jm["conv_w"]).std())) < 0.05


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba_layer(smoke):
    jcfg, cfg = smoke[0], smoke[1]
    jp = jmamba.init_mamba(jcfg, jax.random.PRNGKey(5))
    x = np.random.default_rng(3).normal(size=(B, 64, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _to_port(jp), x


def test_mamba_forward_matches_reference(mamba_layer):
    jcfg, cfg, jp, p, x = mamba_layer
    want, _ = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x))
    got, state = mamba.mamba_forward(cfg, p, torch.from_numpy(x))
    assert state is None
    _close(got, want, TOL)
    plain, _ = mamba.mamba_forward(cfg, p, torch.from_numpy(x), ssd_kernel=False)
    torch.testing.assert_close(plain, got, atol=0.0, rtol=0.0)  # both plain on the CPU


def test_mamba_forward_from_a_state_matches_reference(mamba_layer):
    jcfg, cfg, jp, p, x = mamba_layer
    rng = np.random.default_rng(9)
    st = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in jax.tree.map(np.asarray, jmamba.init_mamba_state(jcfg, B)).items()}
    want, jnew = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    got, new = mamba.mamba_forward(cfg, p, torch.from_numpy(x),
                                   {k: torch.from_numpy(v) for k, v in st.items()})
    _close(got, want, TOL)
    for key in ("ssm", "conv"):
        _close(new[key], jnew[key], TOL)


def test_mamba_state_and_step_match_reference(mamba_layer):
    jcfg, cfg, jp, p, x = mamba_layer
    js = jmamba.init_mamba_state(jcfg, B)
    s = mamba.init_mamba_state(cfg, B)
    assert {k: (tuple(v.shape), v.dtype) for k, v in s.items()} == {
        k: (v.shape, getattr(torch, str(v.dtype))) for k, v in js.items()}
    for t in range(6):
        jy, js = jmamba.mamba_step(jcfg, jp, jnp.asarray(x[:, t:t + 1]), js)
        y, s = mamba.mamba_step(cfg, p, torch.from_numpy(x[:, t:t + 1]), s)
        _close(y, jy, TOL)
    for key in ("ssm", "conv"):
        _close(s[key], js[key], TOL)
    # the step's recursion reproduces the zero-state forward token by token
    full, _ = mamba.mamba_forward(cfg, p, torch.from_numpy(x[:, :16]))
    s = mamba.init_mamba_state(cfg, B)
    for t in range(16):
        y, s = mamba.mamba_step(cfg, p, torch.from_numpy(x[:, t:t + 1]), s)
    torch.testing.assert_close(y[:, 0], full[:, -1], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the whole hybrid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(smoke, use_flash):
    jcfg, cfg, jparams, params = smoke
    tok = _tokens(cfg, seed=1)
    want = jbuild(jcfg).forward(jparams, {"tokens": jnp.asarray(tok)}, use_flash=use_flash)
    logits, aux = hybrid.forward(cfg, params, torch.from_numpy(tok).long(), use_flash=use_flash)
    assert logits.shape == (B, T, cfg.vocab_size) and float(aux) == 0.0
    _close(logits, want, ATTN_TOL)


def test_loss_matches_reference(smoke):
    jcfg, cfg, jparams, params = smoke
    tok = _tokens(cfg, seed=2, t=32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -3:] = -1
    jl, jm = jbuild(jcfg).loss_fn(jparams, {"tokens": jnp.asarray(tok),
                                            "labels": jnp.asarray(labels)})
    loss, m = build(cfg).loss_fn(params, {"tokens": torch.from_numpy(tok).long(),
                                          "labels": torch.from_numpy(labels).long()})
    _close(loss, jl, ATTN_TOL)
    _close(m["ce"], jm["ce"], ATTN_TOL)


def test_decode_step_over_a_replayed_prompt_matches_reference(smoke):
    jcfg, cfg, jparams, params = smoke
    tok = _tokens(cfg, seed=4, t=24)
    jb, b = jbuild(jcfg), build(cfg)
    jcache, cache = jb.init_cache(B, 32), b.init_cache(B, 32)
    assert tree.paths(cache) == tree.paths(_to_port(jax.tree.map(np.asarray, jcache)))
    for t in range(tok.shape[1]):
        jl, jcache = jb.decode_step(jparams, jcache, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        logits, out = b.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]).long(), t)
        assert out is cache  # written in place
        _close(logits, jl, ATTN_TOL)
    for got, want in zip(tree.leaves(cache), jax.tree.leaves(jcache)):
        _close(got, want, ATTN_TOL)


def test_prefill_equals_the_replayed_prompt(smoke):
    """``tests/test_decode_consistency.py``'s check in the port: the prefill
    step's last logits (ssd_scan from a zero state, flash attention) against
    the last serve step of the replayed prompt (ssd_step's recursion, the
    KV cache), 1e-4 in f32."""
    _, cfg, _, params = smoke
    b = build(cfg)
    tok = torch.from_numpy(_tokens(cfg, seed=6, t=64)).long()
    pre = build_step(b, "prefill")(params, {"tokens": tok})
    step, cache = build_step(b, "decode"), b.init_cache(B, 64)
    for t in range(64):
        last, cache = step(params, cache, tok[:, t:t + 1], t)
    _close(last, pre.numpy(), ATTN_TOL)


def test_serve_runs_the_hybrid_end_to_end_on_the_cpu(smoke):
    _, cfg, _, params = smoke
    lines = []
    res = serve_mod.serve(cfg=cfg, batch=3, prompt_len=32, gen=5, device="cpu", seed=1,
                          params=params, log=lines.append)
    assert res.frames is None and res.prompts.shape == (3, 32)
    assert res.tokens.shape == (3, 5) and res.decode_steps == 4
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size
    _close(res.replay_logits, res.prefill_logits.numpy(), ATTN_TOL)
    # the first generated token is the replay's greedy choice
    assert torch.equal(res.tokens[:, 0], torch.argmax(res.replay_logits, -1))
    assert any("frames" not in line and "prefill: 32 tokens x 3 seqs" in line for line in lines)
    drawn = serve_mod.serve(cfg=cfg, batch=2, prompt_len=16, gen=2, device="cpu", log=None)
    assert drawn.tokens.shape == (2, 2) and bool(torch.isfinite(drawn.prefill_logits).all())

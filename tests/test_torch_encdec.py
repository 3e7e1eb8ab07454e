"""seamless-m4t-large-v2 in the port against a live run of the reference:
configs, init, the model's parts, the whole encoder-decoder, the serving
steps and the serving CLI, on the CPU.

The port is fed the reference's own params (``params_from_jax``) and the
same numpy inputs.  Tolerances, as ``max|got - want| <= tol * max(1,
max|want|)``:

* ``TOL = 1e-5`` for the parts without attention (norms, MLPs, RoPE):
  f32 on both sides, sums in another order.
* ``ATTN_TOL = 1e-4`` for anything that goes through attention.  The
  zoo's init scales the projections by the fan-in ``shape[-2]``, which is
  the head count for ``wq (d, H, hd)``, so attention logits come out with
  a standard deviation of about 30 and the softmax is nearly one-hot: a
  one-ulp difference in a projection moves the small weights by ~1e-5 of
  the output's scale (measured: 5.5e-6 of it for one attention call,
  3.3e-5 for the 2+2-layer smoke forward).
* bf16 (the convert repair): the reference's own bf16 run of this model
  is far from its f32 run (a relative L2 error of ~0.3 on the logits:
  nearly one-hot softmaxes flip on bf16 rounding), so the port is held
  to that noise floor (see the test).

The within-port checks follow ``tests/test_decode_consistency.py``:
decode replay against the teacher-forced decoder at 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro.models import mlp as jmlp
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import build_step
from repro_torch.models import ModelConfig, build, count_params
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import encdec as ed
from repro_torch.models import mlp

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
ATTN_TOL = 1e-4
B, T = 2, 16


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
    jcfg = jbase.get_arch(ARCH).smoke()
    cfg = base.get_arch(ARCH).smoke()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _to_port(jparams)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return frames, tokens


def _batches(frames, tokens, labels=None):
    jb = {"prefix": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tb = {"prefix": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens).long()}
    if labels is not None:
        jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    return jb, tb


# ---------------------------------------------------------------------------
# configs, registry, init
# ---------------------------------------------------------------------------


def test_configs_and_registry_match_reference():
    for which in ("full", "smoke"):
        got = dataclasses.asdict(getattr(base.get_arch(ARCH), which)())
        want = dataclasses.asdict(getattr(jbase.get_arch(ARCH), which)())
        assert got == want, which
    mod, jmod = base.get_arch("seamless_m4t_large_v2"), jbase.get_arch(ARCH)
    assert (mod.SHAPES, mod.FRONTEND_FRAMES) == (jmod.SHAPES, jmod.FRONTEND_FRAMES) == (
        ["train_4k", "prefill_32k", "decode_32k"], 960)
    assert base.ARCH_IDS == jbase.ARCH_IDS and base.CLI_ALIASES == jbase.CLI_ALIASES
    assert {k: dataclasses.asdict(v) for k, v in base.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    assert base.supported_shapes(ARCH) == jbase.supported_shapes(ARCH)
    full = mod.full()
    assert (full.hd, full.tdtype) == (64, torch.bfloat16)
    # every arch id of the reference resolves, in either form; only an
    # unknown one raises
    for alias, name in base.CLI_ALIASES.items():
        assert base.get_arch(alias) is base.get_arch(name)
        assert base.get_arch(alias).__name__ == f"repro_torch.configs.{name}"
    with pytest.raises(KeyError):
        base.get_arch("gpt-5")


def test_unported_families_and_the_train_step_raise():
    """Every family builds (the zoo is ported); an unknown arch_type raises,
    and so does the train step without its client count (since item 16 it
    builds the round)."""
    for arch_type in ("dense", "moe", "ssm", "vlm"):
        b = build(ModelConfig(arch_type=arch_type, n_experts=4 if arch_type == "moe" else 0,
                              top_k=2 if arch_type == "moe" else 0))
        assert b.has_decode and b.forward is not None and b.init_cache is not None
    b = build(ModelConfig(arch_type="hybrid", n_layers=8, attn_every=8, moe_every=2,
                          n_experts=4, top_k=2))
    assert sorted(b.init(torch.Generator().manual_seed(0))["periods"]["ffns"]["l1"]) == [
        "router", "wd", "wg", "wu"]
    with pytest.raises(ValueError, match="unknown arch_type"):
        build(ModelConfig(arch_type="diffusion"))
    with pytest.raises(ValueError, match="n_clients"):
        build_step(build(base.get_arch(ARCH).smoke()), "train")
    assert callable(build_step(build(base.get_arch(ARCH).smoke()), "train", n_clients=2))


def test_init_has_the_reference_tree_shapes_and_scales(smoke):
    jcfg, cfg, jparams, _ = smoke
    params = build(cfg).init(torch.Generator().manual_seed(0))
    assert tree.paths(params) == tree.paths(_to_port(jparams))
    for got, want in zip(tree.leaves(params), jax.tree.leaves(jparams)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert count_params(params) == jcommon.count_params(jparams) == 805_888
    # truncated normal at +-2 with std 1/sqrt(shape[-2]) per layer (for
    # wq (d, H, hd) that is the head count), as the reference draws
    wq, jwq = params["decoder"]["self"]["wq"], np.asarray(jparams["decoder"]["self"]["wq"])
    std = 1 / np.sqrt(cfg.n_heads)
    assert float(wq.abs().max()) <= 2 * std * (1 + 1e-6)
    assert abs(float(wq.std()) - float(jwq.std())) < 0.05 * std
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    bf16 = build(cfg.replace(dtype="bfloat16")).init(torch.Generator().manual_seed(0))
    assert all(x.dtype == torch.bfloat16 for x in tree.leaves(bf16))


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm", "nonparametric_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches_reference(smoke, norm, dtype):
    jcfg = smoke[0].replace(norm=norm, dtype=dtype)
    cfg = smoke[1].replace(norm=norm, dtype=dtype)
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(B, T, cfg.d_model)) + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=cfg.d_model)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=cfg.d_model)).astype(np.float32)}
    keys = {"layernorm": ("scale", "bias"), "rmsnorm": ("scale",), "nonparametric_ln": ()}[norm]
    jp = {k: jnp.asarray(p[k]).astype(jcfg.jdtype) for k in keys}
    want = jcommon.apply_norm(jcfg, jp, jnp.asarray(x).astype(jcfg.jdtype))
    got = common.apply_norm(cfg, _to_port(jp), torch.from_numpy(x).to(cfg.tdtype))
    assert got.dtype == cfg.tdtype
    # bf16: the same f32 statistics and the same casts give the same bits
    _close(got, want, TOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("kind", ["gelu", "swiglu", "relu_sq"])
def test_apply_mlp_matches_reference(smoke, kind):
    jcfg, cfg = smoke[0].replace(mlp=kind), smoke[1].replace(mlp=kind)
    jp = jmlp.init_mlp(jcfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(2).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    want = jmlp.apply_mlp(jcfg, jp, jnp.asarray(x))
    _close(mlp.apply_mlp(cfg, _to_port(jp), torch.from_numpy(x)), want, TOL)
    tp = mlp.init_mlp(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(B, T))
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0), want, TOL)
    _close(common.rope_frequencies(32, 10000.0), jcommon.rope_frequencies(32, 10000.0), TOL)


ATTENTION_CASES = {
    "causal_flash": dict(use_flash=True),
    "causal": dict(),
    "bidirectional": dict(causal=False),
    "cross": dict(cross=True, causal=False),
    "chunked": dict(attn_chunk=4),  # T=16 > 4, 16 % 4 == 0: the query-blocked path
    "window": dict(window=5),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_matches_reference(smoke, case):
    kw = dict(ATTENTION_CASES[case])
    chunk = kw.pop("attn_chunk", None)
    jcfg, cfg = smoke[0], smoke[1]
    if chunk is not None:
        jcfg, cfg = jcfg.replace(attn_chunk=chunk), cfg.replace(attn_chunk=chunk)
    jp = jax.tree.map(lambda a: a[0], smoke[2]["decoder"]["cross" if kw.get("cross") else "self"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("cross", None):
        mem = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        del jkw["cross"], tkw["cross"]
        jkw["kv_source"], tkw["kv_source"] = jnp.asarray(mem), torch.from_numpy(mem)
    want = jattn.attention(jcfg, jp, jnp.asarray(x), **jkw)
    got = attn.attention(cfg, _to_port(jp), torch.from_numpy(x), **tkw)
    _close(got, want, ATTN_TOL)


def test_banded_static_window_matches_reference():
    """The statically banded sliding-window path, at the reference test's
    config (``tests/test_decode_consistency.py:95``), GQA with one kv head."""
    kw = dict(d_model=64, n_heads=2, n_kv_heads=1, head_dim=32, vocab_size=64,
              sliding_window=16, attn_chunk=32)
    jcfg, cfg = jcommon.ModelConfig(**kw), ModelConfig(**kw)
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(6).normal(size=(2, 128, 64)).astype(np.float32)
    want = jattn.attention(jcfg, jp, jnp.asarray(x), static_window=16)
    got = attn.attention(cfg, _to_port(jp), torch.from_numpy(x), static_window=16)
    _close(got, want, ATTN_TOL)
    _close(got, attn.attention(cfg, _to_port(jp), torch.from_numpy(x), window=16), ATTN_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_encode_decode_train_and_loss_match_reference(smoke):
    jcfg, cfg, jparams, params = smoke
    frames, tokens = _inputs(cfg, seed=7)
    labels = np.where(np.arange(T)[None] % 5 == 4, -1, np.roll(tokens, -1, 1)).astype(np.int32)
    jb, tb = _batches(frames, tokens, labels)
    jmem = jed.encode(jcfg, jparams, jb["prefix"])
    mem = ed.encode(cfg, params, tb["prefix"])
    _close(mem, jmem, ATTN_TOL)
    want = jed.decode_train(jcfg, jparams, jb["tokens"], jmem, use_flash=True)
    got = ed.decode_train(cfg, params, tb["tokens"], mem, use_flash=True)
    _close(got, want, ATTN_TOL)
    for weighted in (False, True):
        if weighted:
            jb["ce_weight"] = jnp.asarray([0.25, 0.75], jnp.float32)
            tb["ce_weight"] = torch.tensor([0.25, 0.75])
        jloss, jaux = jed.loss_fn(jcfg, jparams, jb, use_flash=True)
        loss, aux = build(cfg).loss_fn(params, tb, use_flash=True)
        _close(loss, jloss, ATTN_TOL)
        assert float(aux["ce"]) == float(loss) and float(aux["moe_aux"]) == 0.0


def _reference_decode(jcfg, jparams, jmem, tokens):
    jbundle = jbuild(jcfg)
    cache = {**jbundle.init_cache(B, T, jcfg.frontend_tokens), "memory": jmem}
    out = []
    for t in range(T):
        logits, cache = jbundle.decode_step(jparams, cache, jnp.asarray(tokens[:, t:t + 1]),
                                            jnp.int32(t))
        out.append(logits)
    return jnp.stack(out, axis=1), cache


def test_decode_step_loop_matches_reference(smoke):
    """16 one-token steps through the KV cache: every step's logits and
    the cache left behind.  Both sides decode against the reference's
    encoder memory: the port's own memory differs from it by ~8e-6 of its
    scale (held by the test above), and the nearly one-hot cross-attention
    turns that into ~3e-4 of the logits' scale, which would hide what this
    test checks."""
    jcfg, cfg, jparams, params = smoke
    frames, tokens = _inputs(cfg, seed=8)
    jmem = jed.encode(jcfg, jparams, jnp.asarray(frames))
    want, jcache = _reference_decode(jcfg, jparams, jmem, tokens)
    bundle = build(cfg)
    cache = bundle.init_cache(B, T, cfg.frontend_tokens)
    cache["memory"] = torch.from_numpy(np.array(jmem))
    step = build_step(bundle, "decode")
    got = []
    for t in range(T):
        logits, cache = step(params, cache, torch.from_numpy(tokens[:, t:t + 1]).long(), t)
        got.append(logits)
    _close(torch.stack(got, dim=1), want, ATTN_TOL)
    for name in ("k", "v"):
        assert tuple(cache["kv"][name].shape) == jcache["kv"][name].shape
        _close(cache["kv"][name], jcache["kv"][name], ATTN_TOL)


def test_prefill_step_matches_reference(smoke):
    """The prefill step (flash self-attention) against the reference's
    prefill, ``bundle.forward(params, batch)[:, -1, :]``, with and without
    its own flash path."""
    jcfg, cfg, jparams, params = smoke
    frames, tokens = _inputs(cfg, seed=9)
    jb, tb = _batches(frames, tokens)
    got = build_step(build(cfg), "prefill")(params, tb)
    assert tuple(got.shape) == (B, cfg.vocab_size)
    for use_flash in (False, True):
        _close(got, jbuild(jcfg).forward(jparams, jb, use_flash=use_flash)[:, -1, :], ATTN_TOL)


def test_decode_replay_and_flash_prefill_agree_within_the_port(smoke):
    """Within the port: the decode loop reproduces the teacher-forced
    decoder (``tests/test_decode_consistency.py``'s check, 2e-2), and the
    flash and plain prefills agree."""
    _, cfg, _, params = smoke
    frames, tokens = _inputs(cfg, seed=10)
    _, tb = _batches(frames, tokens)
    bundle = build(cfg)
    full = bundle.forward(params, tb)
    _close(bundle.forward(params, tb, use_flash=True), full, ATTN_TOL)
    cache = bundle.init_cache(B, T, cfg.frontend_tokens)
    cache["memory"] = ed.encode(cfg, params, tb["prefix"])
    got = []
    for t in range(T):
        logits, cache = bundle.decode_step(params, cache, tb["tokens"][:, t:t + 1], t)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(), atol=2e-2, rtol=2e-2)
    with pytest.raises(IndexError, match="outside the cache"):
        bundle.decode_step(params, cache, tb["tokens"][:, :1], T)


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------


def test_serve_matches_a_live_reference_run(smoke):
    """``serve`` on the CPU with the reference's params: its prefill logits,
    the last replayed decode logits and the greedy tokens against the
    reference's prefill and decode loop on the same frames and prompt."""
    jcfg, cfg, jparams, params = smoke
    P, G = 8, 6
    res = serve_mod.serve(ARCH, smoke=True, batch=B, prompt_len=P, gen=G, device="cpu",
                          params=params, log=None)
    frames, prompts = res.frames.numpy(), res.prompts.numpy().astype(np.int32)
    jbundle = jbuild(jcfg)
    jb = {"prefix": jnp.asarray(frames), "tokens": jnp.asarray(prompts)}
    _close(res.prefill_logits, jbundle.forward(jparams, jb)[:, -1, :], ATTN_TOL)
    cache = {**jbundle.init_cache(B, P + G, jcfg.frontend_tokens),
             "memory": jed.encode(jcfg, jparams, jb["prefix"])}
    for t in range(P):
        logits, cache = jbundle.decode_step(jparams, cache, jb["tokens"][:, t:t + 1], jnp.int32(t))
    _close(res.replay_logits, logits, ATTN_TOL)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for t in range(P, P + G - 1):
        logits, cache = jbundle.decode_step(jparams, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(res.tokens.numpy(), np.concatenate(want, axis=1))
    assert res.decode_steps == G - 1 and res.tokens.shape == (B, G)


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "4", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill: 4 tokens x 2 seqs + 16 frames" in out and "tok/s" in out


# ---------------------------------------------------------------------------
# bf16 through params_from_jax
# ---------------------------------------------------------------------------


def test_params_from_jax_converts_bf16_bitwise(smoke):
    jparams = jbuild(smoke[0].replace(dtype="bfloat16")).init(jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, jparams)
    np_tree["scalar"] = np.asarray(jnp.bfloat16(-1.5))
    params = params_from_jax(np_tree, "cpu")
    assert tree.paths(params) == tree.paths(np_tree)
    for got, want in zip(tree.leaves(params), tree.leaves(np_tree)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      want.view(np.uint16))


def test_bf16_forward_matches_reference_at_bf16_precision(smoke):
    """A bf16 smoke forward through the converted params.  The reference's
    own bf16 logits sit at a relative L2 distance of ~0.3 from its f32 run
    of the same (bf16-valued) params.  The port is held to that floor: no
    farther from the reference's bf16 logits than the reference is from
    f32, and no farther from f32 than 1.25x the reference's distance."""
    jcfg = smoke[0].replace(dtype="bfloat16")
    cfg = smoke[1].replace(dtype="bfloat16")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = _to_port(jparams)
    frames, tokens = _inputs(cfg, seed=0)
    jb, tb = _batches(frames, tokens)
    want = np.asarray(jbuild(jcfg).forward(jparams, jb), np.float32)
    f32 = np.asarray(jbuild(jcfg.replace(dtype="float32")).forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), jparams), jb))
    got = build(cfg).forward(params, tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    floor = rel(want, f32)
    assert 0.0 < floor < 1.0
    assert rel(got, want) <= floor, (rel(got, want), floor)
    assert rel(got, f32) <= 1.25 * floor, (rel(got, f32), floor)

"""The GLA half of ``models/ssm.py``, the RWKV6 block and the MoE layer in
the port against a live run of the reference, on the CPU.

The same numpy inputs (from a seed) and the reference's own params
(``params_from_jax``) go through both packages.  Tolerances, as
``max|got - want| <= tol * max(1, max|want|)``:

* ``TOL = 1e-5``: f32 on both sides, sums in another order.  The GLA
  recurrence reads ~1.4e-6 of its scale at T = 64.
* ``MOE_TOL = 1e-5`` for ``apply_moe``'s output and aux: the same routing
  (the top-k holds the lower expert first among ties in both), the
  experts' matmuls and the K-term combine summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.models import moe, rwkv, ssm

TOL = 1e-5
MOE_TOL = 1e-5
B, T = 2, 64


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


def _to_port(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


# ---------------------------------------------------------------------------
# GLA: gla_chunked, gla_step, gla_reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gla_inputs():
    rng = np.random.default_rng(0)
    H, Dk, Dv = 3, 8, 5
    r, k = (rng.normal(size=(B, T, H, Dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, T, H, Dv)).astype(np.float32)
    logw = -np.exp(rng.normal(size=(B, T, H, Dk))).astype(np.float32)  # decays in (0, 1)
    u = rng.normal(size=(H, Dk)).astype(np.float32)
    state = rng.normal(size=(B, H, Dk, Dv)).astype(np.float32)
    return r, k, v, logw, u, state


def _gla_args(inputs, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(a) for a in inputs[:5]]


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
def test_gla_chunked_matches_reference(gla_inputs, chunk, with_state):
    st = gla_inputs[5] if with_state else None
    jy, jS = jssm.gla_chunked(*_gla_args(gla_inputs, "jax"), chunk=chunk,
                              state=None if st is None else jnp.asarray(st))
    y, S = ssm.gla_chunked(*_gla_args(gla_inputs, "torch"), chunk=chunk,
                           state=None if st is None else torch.from_numpy(st))
    assert y.dtype == torch.float32 and S.dtype == torch.float32
    _close(y, jy, TOL)
    _close(S, jS, TOL)
    # the reference's sequential oracle, token by token through its gla_step
    wy, wS = jssm.gla_reference(*_gla_args(gla_inputs, "jax"),
                                state=None if st is None else jnp.asarray(st))
    _close(y, wy, TOL)
    _close(S, wS, TOL)
    # and the port's own
    py, pS = ssm.gla_reference(*_gla_args(gla_inputs, "torch"),
                               state=None if st is None else torch.from_numpy(st))
    _close(py, wy, TOL)
    _close(pS, wS, TOL)


def test_gla_step_matches_reference(gla_inputs):
    r, k, v, logw, u, st = gla_inputs
    jy, jS = jssm.gla_step(*(jnp.asarray(a[:, 5]) for a in (r, k, v, logw)), jnp.asarray(u),
                           jnp.asarray(st))
    y, S = ssm.gla_step(*(torch.from_numpy(a[:, 5]) for a in (r, k, v, logw)),
                        torch.from_numpy(u), torch.from_numpy(st))
    _close(y, jy, TOL)
    _close(S, jS, TOL)


def test_gla_chunked_keeps_the_dtype_and_an_f32_state(gla_inputs):
    args = [a.to(torch.bfloat16) for a in _gla_args(gla_inputs, "torch")[:3]]
    logw, u = _gla_args(gla_inputs, "torch")[3:]
    y, S = ssm.gla_chunked(*args, logw, u, chunk=16)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    with pytest.raises(ValueError, match="not divisible"):
        ssm.gla_chunked(*_gla_args(gla_inputs, "torch"), chunk=24)


# ---------------------------------------------------------------------------
# RWKV6: the block's parts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv_layer():
    jcfg = jbase.get_arch("rwkv6-1.6b").smoke()
    cfg = base.get_arch("rwkv6-1.6b").smoke()
    jtm = jrwkv.init_rwkv_time_mix(jcfg, jax.random.PRNGKey(1))
    jcm = jrwkv.init_rwkv_channel_mix(jcfg, jax.random.PRNGKey(2))
    x = np.random.default_rng(3).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jtm, jcm, _to_port(jtm), _to_port(jcm), x


def test_rwkv_init_matches_reference_tree_and_dtypes():
    for dtype in ("float32", "bfloat16"):
        jcfg = jbase.get_arch("rwkv6-1.6b").smoke().replace(dtype=dtype)
        cfg = base.get_arch("rwkv6-1.6b").smoke().replace(dtype=dtype)
        g = torch.Generator().manual_seed(0)
        for jinit, init in ((jrwkv.init_rwkv_time_mix, rwkv.init_rwkv_time_mix),
                            (jrwkv.init_rwkv_channel_mix, rwkv.init_rwkv_channel_mix)):
            want = jinit(jcfg, jax.random.PRNGKey(0))
            got = init(cfg, g)
            assert sorted(got) == sorted(want)
            for key, w in want.items():
                assert tuple(got[key].shape) == w.shape and str(got[key].dtype)[6:] == str(w.dtype)
                if key in ("mu", "w0", "u", "gn_scale", "gn_bias"):  # deterministic in both
                    _close(got[key], w, 0.0)
        # w0 and u stay f32 in a bf16 model
        tm = rwkv.init_rwkv_time_mix(cfg, g)
        assert tm["w0"].dtype == tm["u"].dtype == torch.float32


@pytest.mark.parametrize("streaming", [False, True], ids=["stateless", "from_a_state"])
def test_time_and_channel_mix_match_reference(rwkv_layer, streaming):
    jcfg, cfg, jtm, jcm, tm, cm, x = rwkv_layer
    jst = st = None
    if streaming:
        rng = np.random.default_rng(4)
        shapes = jax.tree.map(np.asarray, jrwkv.init_rwkv_state(jcfg, B))
        raw = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
        jst, st = jax.tree.map(jnp.asarray, raw), _to_port(raw)
    want, jnew = jrwkv.time_mix(jcfg, jtm, jnp.asarray(x), None if jst is None else jst["tm"])
    got, new = rwkv.time_mix(cfg, tm, torch.from_numpy(x), None if st is None else st["tm"])
    _close(got, want, TOL)
    jc, jcs = jrwkv.channel_mix(jcfg, jcm, jnp.asarray(x), None if jst is None else jst["cm"])
    c, cs = rwkv.channel_mix(cfg, cm, torch.from_numpy(x), None if st is None else st["cm"])
    _close(c, jc, TOL)
    if streaming:
        _close(new["shift"], jnew["shift"], TOL)
        _close(new["wkv"], jnew["wkv"], TOL)
        _close(cs, jcs, TOL)
    else:
        assert new is None and cs is None


def test_time_mix_decode_fast_path_matches_reference(rwkv_layer):
    """T = 1 with a state takes gla_step in both packages; stepping the
    prompt token by token reproduces the stateless forward."""
    jcfg, cfg, jtm, _, tm, _, x = rwkv_layer
    jst = jrwkv.init_rwkv_state(jcfg, B)["tm"]
    st = rwkv.init_rwkv_state(cfg, B)["tm"]
    for t in range(8):
        jy, jst = jrwkv.time_mix(jcfg, jtm, jnp.asarray(x[:, t:t + 1]), jst)
        y, st = rwkv.time_mix(cfg, tm, torch.from_numpy(x[:, t:t + 1]), st)
        _close(y, jy, TOL)
    _close(st["wkv"], jst["wkv"], TOL)
    full, _ = rwkv.time_mix(cfg, tm, torch.from_numpy(x[:, :16]))
    st = rwkv.init_rwkv_state(cfg, B)["tm"]
    for t in range(16):
        y, st = rwkv.time_mix(cfg, tm, torch.from_numpy(x[:, t:t + 1]), st)
    _close(y[:, 0], full[:, -1].numpy(), 1e-4)


def test_group_norm_and_state_match_reference():
    jcfg = jbase.get_arch("rwkv6-1.6b").smoke()
    cfg = base.get_arch("rwkv6-1.6b").smoke()
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(B, 4, cfg.d_model)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.normal(size=(cfg.d_model,)).astype(np.float32) for _ in range(2))
    want = jrwkv._group_norm(jnp.asarray(x), 2, jnp.asarray(scale), jnp.asarray(bias))
    got = rwkv._group_norm(torch.from_numpy(x), 2, torch.from_numpy(scale),
                           torch.from_numpy(bias))
    _close(got, want, TOL)
    js, s = jrwkv.init_rwkv_state(jcfg, 3), rwkv.init_rwkv_state(cfg, 3)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), js) == {
        "tm": {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in s["tm"].items()},
        "cm": (tuple(s["cm"].shape), str(s["cm"].dtype)[6:])}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_layer():
    jcfg = jbase.get_arch("granite-moe-3b-a800m").smoke()
    cfg = base.get_arch("granite-moe-3b-a800m").smoke()
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(7))
    return jcfg, cfg, jp, _to_port(jp)


def test_capacity_matches_reference():
    cfg = base.get_arch("granite-moe-3b-a800m").full()
    jcfg = jbase.get_arch("granite-moe-3b-a800m").full()
    for n in (1, 4, 255, 256, 4096, 32768):
        for cf in (0.25, 1.0, 1.25):
            got = moe.capacity(n, cfg.replace(capacity_factor=cf))
            assert got == jmoe.capacity(n, jcfg.replace(capacity_factor=cf))
            assert got >= 128 and got % 128 == 0


@pytest.mark.parametrize("capacity_factor,t", [(1.25, 64), (0.25, 256)],
                         ids=["no_drops", "drops"])
def test_apply_moe_matches_reference(moe_layer, capacity_factor, t):
    jcfg, cfg, jp, p = moe_layer
    jcfg, cfg = (c.replace(capacity_factor=capacity_factor) for c in (jcfg, cfg))
    x = np.random.default_rng(8).normal(size=(B, t, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    got, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    _close(got, want, MOE_TOL)
    _close(aux, jaux, MOE_TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    r = moe.route(cfg, p, torch.from_numpy(x).reshape(-1, cfg.d_model))
    n_dropped = int((~r.keep).sum())
    if capacity_factor < 1:  # 2 x 256 tokens x top-2 over 4 experts of 128 slots
        assert r.capacity == 128 and n_dropped > 0
        # a dropped assignment adds nothing: tokens whose every choice
        # was dropped come out zero
        none_kept = ~r.keep.view(-1, cfg.top_k).any(1)
        assert torch.equal(got.reshape(-1, cfg.d_model)[none_kept],
                           torch.zeros(int(none_kept.sum()), cfg.d_model))
    else:
        assert n_dropped == 0


def test_route_breaks_ties_like_xla_top_k(moe_layer):
    """Equal router scores: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    _, cfg, _, p = moe_layer
    E = cfg.n_experts
    router = torch.zeros_like(p["router"])
    router[:, 3] = 1.0  # expert 3 ahead of three tied experts, or tied with them
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(16, cfg.d_model))
                         .astype(np.float32))
    x[::2] = 0.0  # even tokens: all E scores equal
    r = moe.route(cfg, {**p, "router": router}, x)
    logits = np.asarray(x @ router)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), cfg.top_k)
    assert torch.equal(r.expert, torch.from_numpy(np.array(want)).long())
    assert torch.equal(r.expert[0], torch.arange(cfg.top_k))
    assert E > cfg.top_k


def test_apply_moe_slots_follow_route_priority(moe_layer):
    """Slots count earlier assignments to the same expert over the
    flattened (N*K,) list; past the capacity an assignment goes to the
    dropped row E*C."""
    _, cfg, _, p = moe_layer
    E, K = cfg.n_experts, cfg.top_k
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(600, cfg.d_model))
                         .astype(np.float32))
    r = moe.route(cfg.replace(capacity_factor=0.25), p, x)
    C = r.capacity
    seen = [0] * E
    for i, e in enumerate(r.expert.reshape(-1).tolist()):
        want = e * C + seen[e] if seen[e] < C else E * C
        assert int(r.slot[i]) == want
        seen[e] += 1
    assert sum(max(0, s - C) for s in seen) == int((~r.keep).sum()) > 0
    assert torch.allclose(r.gate.sum(-1), torch.ones(600))

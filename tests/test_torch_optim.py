"""The port's optimizers and learning-rate schedules against the
reference's (``repro.optim``), on the CPU: five steps of each on the same
numpy trees (an f32 matrix, a vector and a bf16 leaf), the updates and
the optimizer states held at rtol 1e-6; ``apply_updates`` in bf16 bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim, tree
from repro_torch.convert import params_from_jax

RTOL = 1e-6
STEPS = 5


def _tree(rng, bf16=True):
    t = {"w": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    if bf16:
        t["h"] = np.asarray(jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16))
    return t


def _held(got, want):
    gl, wl = tree.leaves(got), [np.asarray(x) for x in tree.leaves(want)]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=RTOL, atol=1e-7)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_wd": lambda m: m.sgd(0.05, weight_decay=1e-2),
    "sgd_inverse_round_decay": lambda m: m.sgd(m.inverse_round_decay(4.0, 8)),
    "sgd_cosine": lambda m: m.sgd(m.cosine_decay(0.3, 4)),
    "momentum": lambda m: m.sgd_momentum(1.0, beta=0.9),
    "momentum_wd_nesterov": lambda m: m.sgd_momentum(0.2, beta=0.8, weight_decay=1e-2,
                                                     nesterov=True),
    "momentum_warmup_cosine": lambda m: m.sgd_momentum(m.warmup_cosine(0.5, 2, 5), beta=0.9,
                                                       nesterov=True),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_wd": lambda m: m.adamw(m.constant(3e-3), b1=0.8, b2=0.99, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](optim)
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, params_from_jax(p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(STEPS):
        g = _tree(rng)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update(params_from_jax(g, "cpu"), ts, tp)
        _held(tu, ju)
        _held(ts, js)
        assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
        jp, tp = jopt.apply_updates(jp, ju), optim.apply_updates(tp, tu)
    _held(tp, jp)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)),
    ("inverse_round_decay", (4.0, 8, 2.0)),
    ("cosine_decay", (0.3, 7, 0.2)),
    ("warmup_cosine", (0.5, 3, 10, 0.1)),
])
def test_schedule_matches_reference(name, args):
    js, ts = getattr(jopt, name)(*args), getattr(optim, name)(*args)
    for s in range(12):
        got = ts(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(js(jnp.int32(s))), rtol=RTOL)


def test_apply_updates_bf16_is_bitwise():
    rng = np.random.default_rng(1)
    p = _tree(rng)
    u = {k: rng.normal(size=np.shape(v)).astype(np.float32) * 1e-2 for k, v in p.items()}
    want = jopt.apply_updates({k: jnp.asarray(v) for k, v in p.items()},
                              {k: jnp.asarray(v) for k, v in u.items()})
    got = optim.apply_updates(params_from_jax(p, "cpu"), params_from_jax(u, "cpu"))
    assert got["h"].dtype == torch.bfloat16
    for k in p:
        assert torch.equal(got[k], params_from_jax(np.asarray(want[k]), "cpu")), k


def test_schedule_follows_the_step_on_its_device():
    """The schedules read the step only on the device: the same callable
    gives the step's own rate as the step tensor advances in place."""
    sched = optim.inverse_round_decay(4.0, 8)
    step = torch.zeros((), dtype=torch.int32)
    seen = []
    for _ in range(3):
        seen.append(float(sched(step)))
        step.add_(1)
    assert seen == [float(np.float32(4.0) / np.float32(s * 8 + 1)) for s in range(3)]

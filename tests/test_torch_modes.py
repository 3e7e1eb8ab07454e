"""The port's other round modes (``client_sequential``, ``weighted_grad``,
``weighted_flat``) against live reference runs, on the CPU.

1. ``client_sequential`` and ``weighted_grad`` through ``build_experiment``
   for the quadratic task and the reduced CIFAR CNN, against the
   reference's ``build_experiment`` with the same spec and seed (so the
   same data, batches, taus and COPT-alpha weights; ``weighted_grad``
   draws all T batches and trains on the first, in both packages), the
   port fed the reference's init params: participation and uplink_bits
   equal, weight_sum at atol 1e-6, loss at rtol 1e-5, params at atol 1e-6
   after two rounds (the tolerances of ``tests/test_torch_slice.py``).
   Not ``tests/golden/round_golden.npz``: its clustered C=1 goldens of
   these modes fail on the reference itself under this jax.
2. ``weighted_flat`` and ``weighted_grad`` through ``make_round_fn`` on
   jamba's smoke config without experts (the CNN's loss takes no
   ``ce_weight``, in the reference either), against the reference's
   rounds on the same params, batches and taus: params within
   ``max(1e-6, 2e-5 * max|update|)`` of the reference's for each leaf,
   where the update is the leaf's change in the round (f32 on both sides,
   the backward's sums over 256 tokens in another order; the largest
   difference, 1.7e-6, is on the embedding, whose update reaches 0.23),
   loss at rtol 1e-5.
3. The port's own equivalences, mirroring ``tests/test_fl_round.py``:
   ``client_sequential`` == ``per_client`` (40 rounds of the quadratic on
   fig2a, distance to the optimum within 1e-4), ``weighted_grad`` ==
   ``per_client`` at T = 1 (1e-4), ``weighted_flat`` == ``weighted_grad``
   (atol 2e-5, rtol 2e-4).
4. The gate: outside ``per_client`` a stateful or non-collapsible strategy
   (``memory``, ``quantized``, async) raises ``ValueError`` when the round
   is built.
5. Chunked == per-round bitwise for the new modes (``run(chunk=K)``, as
   ``tests/test_torch_scan.py`` holds the ``per_client`` paths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro.fl.round import RoundConfig as JRoundConfig
from repro.fl.round import make_round_fn as jmake_round_fn
from repro.models import build as jbuild
from repro.optim import sgd as jsgd
from repro.optim import sgd_momentum as jsgd_momentum
from repro_torch import strategies, tree
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.core.connectivity import sample_round
from repro_torch.core.weights import optimize_weights
from repro_torch.data.pipeline import ClientDataset
from repro_torch.data.synthetic import quadratic_problem
from repro_torch.fl.experiment import ExperimentSpec, build_experiment
from repro_torch.fl.round import RoundConfig, make_round_fn
from repro_torch.fl.trainer import FLTrainer
from repro_torch.models import build
from repro_torch.optim import sgd, sgd_momentum
from test_torch_scan import _assert_same
from test_torch_slice import SPECS

ROUNDS = 2
JAMBA = "jamba-1.5-large-398b"


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Tiny CPU convolutions run fastest and most repeatably on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- 1. the trainer's modes against live reference runs ---------------------------


@pytest.mark.parametrize("mode", ["client_sequential", "weighted_grad"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_mode_tracks_reference(model, mode):
    jexp = jbuild_experiment(JExperimentSpec(**SPECS[model], mode=mode))
    init = jax.tree.map(np.array, jexp.trainer.params)
    jexp.run(ROUNDS)
    jlog, jfinal = jexp.log, jax.tree.map(np.array, jexp.trainer.params)
    exp = build_experiment(ExperimentSpec(**SPECS[model], mode=mode), device="cpu")
    exp.trainer.params = params_from_jax(init, "cpu")
    log = exp.run(ROUNDS)
    assert log.rounds == jlog.rounds == list(range(ROUNDS))
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jlog.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    assert tree.paths(exp.params) == tree.paths(jfinal)
    for got, want in zip(tree.leaves(exp.params), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- 2. weighted_flat and weighted_grad on the hybrid LM ----------------------------


def _lm_round_inputs(vocab, n=4, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    m = topology.fully_connected(n, 0.6, p_c=0.8)
    tu, td = sample_round(m, rng)
    toks = rng.integers(0, vocab, size=(n, B, S + 1), dtype=np.int32)
    A = (np.eye(n) * 2.0).astype(np.float32)
    per_client = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    flat = {k: v.reshape(n * B, S) for k, v in per_client.items()}
    return n, tu.astype(np.float32), td.astype(np.float32), A, per_client, flat


@pytest.fixture(scope="module")
def jamba_smoke():
    """(reference bundle, port bundle, reference params) of jamba's smoke
    config without experts."""
    jcfg = jbase.get_arch(JAMBA).smoke().replace(moe_every=0)
    cfg = base.get_arch(JAMBA).smoke().replace(moe_every=0)
    jbundle = jbuild(jcfg)
    return jbundle, build(cfg), jbundle.init(jax.random.PRNGKey(0))


def _port_lm_round(bundle, params, mode, inputs):
    n, tu, td, A, per_client, flat = inputs
    server = sgd_momentum(1.0, beta=0.0)
    rc = RoundConfig(n_clients=n, local_steps=1, mode=mode,
                     aggregation=strategies.get("colrel", fused="collapse"))
    batches = {k: torch.from_numpy(v).long()
               for k, v in (flat if mode == "weighted_flat" else per_client).items()}
    fn = make_round_fn(bundle.loss_fn, sgd(0.1), server, rc)
    p, _, _, m = fn(params, server.init(params), (), batches, torch.from_numpy(tu),
                    torch.from_numpy(td), torch.from_numpy(A))
    return p, m


@pytest.mark.parametrize("mode", ["weighted_flat", "weighted_grad"])
def test_lm_weighted_modes_track_reference(jamba_smoke, mode):
    jbundle, bundle, jparams = jamba_smoke
    inputs = _lm_round_inputs(bundle.cfg.vocab_size)
    n, tu, td, A, per_client, flat = inputs
    server = jsgd_momentum(1.0, beta=0.0)
    jrc = JRoundConfig(n_clients=n, local_steps=1, mode=mode, aggregation="colrel")
    jfn = jax.jit(jmake_round_fn(jbundle.loss_fn, jsgd(0.1), server, jrc))
    jb = {k: jnp.asarray(v) for k, v in (flat if mode == "weighted_flat" else per_client).items()}
    jp, _, _, jm = jfn(jparams, server.init(jparams), (), jb, jnp.asarray(tu), jnp.asarray(td),
                       jnp.asarray(A))
    p0 = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    p, m = _port_lm_round(bundle, p0, mode, inputs)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=0)
    assert float(m["weight_sum"]) == pytest.approx(float(jm["weight_sum"]), abs=1e-6)
    assert tree.paths(p) == tree.paths(jax.tree.map(np.asarray, jp))
    for got, want, before in zip(tree.leaves(p), jax.tree.leaves(jp), tree.leaves(p0)):
        upd = np.asarray(want) - before.numpy()
        err = np.abs((got - before).numpy() - upd).max()
        assert err <= max(1e-6, 2e-5 * np.abs(upd).max()), (err, np.abs(upd).max())


def test_weighted_flat_equals_weighted_grad(jamba_smoke):
    """The flat round (per-sequence loss weights) gives the global update
    of the per-client weighted_grad round."""
    _, bundle, jparams = jamba_smoke
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    inputs = _lm_round_inputs(bundle.cfg.vocab_size)
    out = {mode: _port_lm_round(bundle, params, mode, inputs)[0]
           for mode in ("weighted_grad", "weighted_flat")}
    for a, b in zip(tree.leaves(out["weighted_grad"]), tree.leaves(out["weighted_flat"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-4)


def test_weighted_flat_repeats_each_weight():
    """``jnp.repeat(w, B)`` repeats each element: client i's weight lands
    on sequences ``i*B .. i*B+B-1`` (``repeat_interleave``, not
    ``Tensor.repeat``)."""
    n, B = 3, 2
    seen = {}

    def loss_fn(params, batch):
        seen["w"] = batch["ce_weight"].detach().clone()
        return torch.sum(batch["ce_weight"] * torch.sum(batch["x"] * params["x"], -1)), {}

    w = torch.tensor([0.5, 0.2, 0.3])
    strategy = strategies.FedAvgPerfect()
    strategy.weights = lambda tu, td, A: w
    rc = RoundConfig(n_clients=n, local_steps=1, mode="weighted_flat", aggregation=strategy)
    fn = make_round_fn(loss_fn, sgd(0.1), sgd_momentum(1.0, beta=0.0), rc)
    p = {"x": torch.zeros(4)}
    fn(p, sgd_momentum(1.0, beta=0.0).init(p), (), {"x": torch.ones(n * B, 4)},
       torch.ones(n), torch.ones(n, n), torch.eye(n))
    assert torch.equal(seen["w"], torch.tensor([0.25, 0.25, 0.1, 0.1, 0.15, 0.15]))


# -- 3. the port's own equivalences -------------------------------------------------

PROB = quadratic_problem(10, 16, mu=1.0, L=8.0, hetero=1.0, seed=0)
H = torch.as_tensor(PROB["H"], dtype=torch.float32)
XSTAR = torch.as_tensor(PROB["x_star"], dtype=torch.float32)
FIG2A = topology.paper_fig2a()
RES = optimize_weights(FIG2A, sweeps=20, fine_tune_sweeps=20)


def _quad_loss(params, batch):
    d = params["x"] - batch["center"][0]
    return 0.5 * d @ (H @ d) + 0.1 * batch["noise"][0] @ params["x"], {}


def _clients(seed):
    out = []
    for i in range(10):
        c = PROB["centers"][i].astype(np.float32)
        pool = np.random.default_rng(100 + i).normal(size=(2048, 16)).astype(np.float32)
        out.append(ClientDataset({"center": np.tile(c, (2048, 1)), "noise": pool},
                                 batch_size=1, seed=seed + i))
    return out


def _dist(mode="per_client", rounds=40, local_steps=4):
    t = FLTrainer(_quad_loss, {"x": torch.zeros(16)}, FIG2A, RES.A, _clients(7), sgd(0.02),
                  sgd_momentum(1.0, beta=0.0), local_steps=local_steps,
                  strategy=strategies.get("colrel", fused="collapse"), mode=mode, device="cpu")
    t.run(rounds)
    return float(torch.sum((t.params["x"] - XSTAR) ** 2))


def test_sequential_equals_per_client():
    assert abs(_dist() - _dist("client_sequential")) < 1e-4


def test_weighted_grad_equals_per_client_at_T1():
    assert abs(_dist(local_steps=1) - _dist("weighted_grad", local_steps=1)) < 1e-4


# -- 4. the gate ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["client_sequential", "weighted_grad", "weighted_flat"])
@pytest.mark.parametrize("strategy", ["memory", "quantized", "async_colrel"])
def test_stateful_strategies_need_per_client(strategy, mode):
    rc = RoundConfig(n_clients=10, local_steps=1, mode=mode, aggregation=strategy)
    with pytest.raises(ValueError, match="needs the per_client mode"):
        make_round_fn(_quad_loss, sgd(0.1), sgd_momentum(1.0), rc)


@pytest.mark.parametrize("mode", ["client_sequential", "weighted_grad"])
def test_trainer_gate_through_spec(mode):
    with pytest.raises(ValueError, match="needs the per_client mode"):
        build_experiment(ExperimentSpec(model="quadratic", strategy="memory", mode=mode),
                         device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        build_experiment(ExperimentSpec(model="quadratic", mode="sequential"), device="cpu")


# -- 5. chunked == per-round ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["client_sequential", "weighted_grad"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_mode_chunked_equals_per_round(model, mode):
    spec = ExperimentSpec(**SPECS[model], mode=mode, strategy_options={"fused": "kernel"})
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(4)
    b.run(4, chunk=2)
    _assert_same(a.trainer, b.trainer)
    assert b.trainer._scan_fn is not None
    if mode == "weighted_grad":
        assert all(v.shape[1] == 10 and v.shape[2] == a.trainer.clients[0].batch_size
                   for v in b.trainer._scan_fn._slot.xs.values())

"""The port's async relaying (``AsyncRelayStrategy``, ``async_colrel``,
``FLTrainer(mode="async")``) against the reference, on the CPU.

1. Bitwise against the reference, on the same numpy inputs:
   ``delivered_mask`` in its dense and ``(C, m, m)`` block forms, and the
   carry recurrence ``advance`` (delivery, age, staging) over a blockage
   trace, mirroring ``tests/test_property.py``.  The staleness weights
   ``gamma**age / sum`` at rtol 1e-6 (``torch.pow`` and XLA's ``pow`` may
   differ by an ulp for age > 0); the age-0 multiplier is exactly 1.0 for
   every n up to 64 (``n / sum`` as a true division).
2. Zero blockage equals sync, bitwise: the async aggregate and the async
   round against the inner ``colrel`` ones, on every monolithic path.
3. Segmented against monolithic, as ``tests/test_larged.py`` holds them:
   ``age`` and ``staging`` (hence the staleness metrics) bitwise, the
   delta at 2e-6; the one row-stream pass over the staging buffer equals
   the per-leaf passes bitwise; the staging buffer is written in place.
4. ``aggregate_tree`` against the reference's on a pre-aged carry: age
   and staging equal, the delta at atol 1e-6.
5. Through the trainer, ``mode="async"`` with ``async_options`` and
   ``strategy="async_colrel"``, against live reference runs under the
   Markov channel.  The two packages' Markov draws differ (held by their
   law in ``tests/test_torch_channel.py``), so the reference trainer is
   served the port's taus round by round; for ``no_trace`` those are the
   port's in-round sampler draws, taken from the same generator stream
   outside the engine.  Per round, chunked and ``no_trace``: participation,
   uplink_bits and ``max_age`` equal (ages are integers from the same
   taus), ``mean_age`` and ``stale_frac`` at rtol 1e-6 (means of the same
   ages, summed in another order), loss at rtol 1e-5, params at atol 1e-6
   (the tolerances of ``tests/test_torch_slice.py``).  Chunked equals per
   round bitwise with all eight metrics.
6. The trainer's ``ValueError`` cases, and ``donate=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.core import flatten as jflatten
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro.strategies.async_relay import AsyncRelayStrategy as JAsyncRelayStrategy
from repro.strategies.async_relay import delivered_mask as jdelivered_mask
from repro.strategies.base import ExecutionContext as JExecutionContext
from repro.telemetry import MemorySink, MetricsLogger
from repro_torch import strategies, tree
from repro_torch.configs.channels import make_channel
from repro_torch.convert import params_from_jax
from repro_torch.core import flatten
from repro_torch.fl.experiment import ExperimentSpec, build_experiment
from repro_torch.fl.round import (
    ASYNC_METRIC_KEYS,
    METRIC_KEYS,
    RoundConfig,
    make_async_round_fn,
    make_round_fn,
)
from repro_torch.kernels import ops
from repro_torch.optim import sgd, sgd_momentum
from repro_torch.strategies import AsyncRelayStrategy, delivered_mask
from repro_torch.strategies.base import ExecutionContext
from test_torch_scan import _assert_same
from test_torch_slice import SPECS

N = 5
# awkward layouts: prime sizes, 1-element leaves, a single-leaf tree
AWKWARD = [
    [(7, 3), (1,), (13,), (2, 5, 3)],
    [(1,), (1,), (1,)],
    [(37,)],
]
ASYNC_OPTIONS = {"gamma": 0.8, "opportunistic": False}  # ages grow on fig2b
ROUNDS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Tiny CPU convolutions run fastest and most repeatably on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _taus(rng, n, blocks=None):
    tau_up = (rng.random(n) < 0.5).astype(np.float32)
    if blocks is None:
        tau_dd = (rng.random((n, n)) < 0.5).astype(np.float32)
        np.fill_diagonal(tau_dd, 1.0)
    else:
        C, m = blocks
        tau_dd = (rng.random((C, m, m)) < 0.5).astype(np.float32)
        tau_dd[:, np.arange(m), np.arange(m)] = 1.0
    return tau_up, tau_dd


def _stacked(shapes, seed, n=N):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.normal(size=(n, *s)).astype(np.float32) for i, s in enumerate(shapes)}


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _same_metrics(a, b) -> None:
    """Every round metric of two trainers, bitwise (NaN equal to NaN)."""
    assert set(a.round_metrics) == set(b.round_metrics) == set(METRIC_KEYS + ASYNC_METRIC_KEYS)
    for k, v in a.round_metrics.items():
        np.testing.assert_array_equal(v, b.round_metrics[k], err_msg=k)


# -- 1. bitwise against the reference -------------------------------------------------


@pytest.mark.parametrize("opportunistic", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_delivered_mask_bitwise(seed, opportunistic):
    rng = np.random.default_rng(seed)
    for blocks, n in ((None, 10), ((3, 4), 12), ((1, 7), 7)):
        tu, td = _taus(rng, n, blocks)
        got = delivered_mask(torch.from_numpy(tu), torch.from_numpy(td),
                             opportunistic=opportunistic)
        _eq(got, jdelivered_mask(jnp.asarray(tu), jnp.asarray(td), opportunistic=opportunistic))
        if blocks is None and opportunistic:
            _eq(got, np.maximum(tu, (td * tu[None, :]).max(axis=1)))


@pytest.mark.parametrize("opportunistic", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_age_recurrence_bitwise(seed, opportunistic):
    """Over a blockage trace: delivery, age and staging equal the
    reference's; a delivered client resets to 0 and refreshes its row, a
    blocked one ages and keeps it."""
    rng = np.random.default_rng(seed)
    n, d = 6, 5
    s = AsyncRelayStrategy(gamma=0.9, opportunistic=opportunistic)
    js = JAsyncRelayStrategy(gamma=0.9, opportunistic=opportunistic)
    age, staging = torch.zeros(n, dtype=torch.int32), torch.zeros(n, d)
    jage, jstaging = jnp.zeros(n, jnp.int32), jnp.zeros((n, d), jnp.float32)
    for _ in range(8):
        tu, td = _taus(rng, n)
        stack = rng.normal(size=(n, d)).astype(np.float32)
        deliv, age2, staging2 = s.advance(age, staging, torch.from_numpy(stack),
                                          torch.from_numpy(tu), torch.from_numpy(td))
        jdeliv, jage, jstaging = js.advance(jage, jstaging, jnp.asarray(stack), jnp.asarray(tu),
                                            jnp.asarray(td))
        for got, want in ((deliv, jdeliv), (age2, jage), (staging2, jstaging)):
            _eq(got, want)
        assert age2.dtype == torch.int32
        up = deliv.numpy() > 0
        _eq(age2[up], np.zeros(up.sum(), np.int32))
        _eq(age2[~up], age.numpy()[~up] + 1)
        _eq(staging2[~up], staging.numpy()[~up])
        age, staging = age2, staging2


def test_advance_age_where_free_bitwise():
    rng = np.random.default_rng(3)
    age = torch.as_tensor(rng.integers(0, 9, size=64), dtype=torch.int32)
    deliv = torch.as_tensor((rng.random(64) < 0.5).astype(np.float32))
    got = AsyncRelayStrategy._advance_age(age, deliv)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.where(deliv > 0, 0, age + 1).to(torch.int32))


@pytest.mark.parametrize("gamma", [0.5, 0.8, 0.9, 1.0])
def test_staleness_weights(gamma):
    s, js = AsyncRelayStrategy(gamma=gamma), JAsyncRelayStrategy(gamma=gamma)
    for seed in range(4):
        ages = np.random.default_rng(seed).integers(0, 20, 16).astype(np.int32)
        w = s.staleness_weights(torch.from_numpy(ages))
        np.testing.assert_allclose(w.numpy(), np.asarray(js.staleness_weights(jnp.asarray(ages))),
                                   rtol=1e-6, atol=0)
        assert (w > 0).all() and abs(float(w.sum()) - 1.0) <= 1e-6
    # the age-0 multiplier is exactly 1.0, so _effective returns the staged rows
    for n in range(1, 65):
        assert torch.equal(s._multipliers(torch.zeros(n, dtype=torch.int32)), torch.ones(n))
    staging = torch.randn(7, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(s._effective(torch.zeros(7, dtype=torch.int32), staging), staging)


# -- 2. zero blockage == sync -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_zero_blockage_aggregate_is_sync_bitwise(seed):
    rng = np.random.default_rng(seed)
    n, d = 6, 9
    a = strategies.get("async_colrel")
    A = torch.as_tensor(rng.uniform(0.0, 1.0, (n, n)), dtype=torch.float32)
    ones = torch.ones(n)
    state = a.init_state(n, d)
    for _ in range(3):
        tau_dd = torch.as_tensor(rng.random((n, n)) < 0.7, dtype=torch.float32)
        updates = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32)
        got, state = a.aggregate(updates, ones, tau_dd, A, state)
        want, _ = a.inner.aggregate(updates, ones, tau_dd, A, ())
        assert torch.equal(got, want)
        assert not state["age"].any()


@pytest.mark.parametrize("fused", [False, "collapse", "kernel"])
def test_zero_blockage_round_is_sync_bitwise(fused):
    """Rounds of the async round function with every uplink up against
    the sync colrel round on the same inputs: params, server state and the
    shared metrics bitwise (``weight_sum`` is NaN for the async strategy,
    which does not collapse), every age 0."""
    n, T, K = 6, 2, 3
    rng = np.random.default_rng(1)
    Hm = torch.as_tensor(np.diag(np.linspace(1.0, 4.0, 6)), dtype=torch.float32)

    def loss_fn(params, batch):
        r = params["x"] - batch["t"][0]
        return 0.5 * r @ (Hm @ r), {}

    batches = torch.as_tensor(rng.normal(size=(K, n, T, 1, 6)), dtype=torch.float32)
    tau_dd = torch.as_tensor(rng.random((K, n, n)) < 0.6, dtype=torch.float32)
    A = torch.as_tensor(rng.random((n, n)) * 0.5, dtype=torch.float32)
    copt, sopt = sgd(0.1), sgd_momentum(1.0, beta=0.9)
    inner = strategies.get("colrel", fused=fused)
    sync = make_round_fn(loss_fn, copt, sopt, RoundConfig(n, T, aggregation=inner))
    strategy = AsyncRelayStrategy(inner=inner)
    asyn = make_async_round_fn(loss_fn, copt, sopt, RoundConfig(n, T, aggregation=strategy))
    assert asyn.metric_keys == METRIC_KEYS + ASYNC_METRIC_KEYS
    p = q = {"x": torch.zeros(6)}
    ps, qs, qa = sopt.init(p), sopt.init(q), strategy.init_state(n, 6)
    for i in range(K):
        args = ({"t": batches[i]}, torch.ones(n), tau_dd[i], A)
        p, ps, _, m = sync(p, ps, (), *args)
        q, qs, qa, mq = asyn(q, qs, qa, *args)
        assert torch.equal(p["x"], q["x"]) and torch.equal(ps["m"]["x"], qs["m"]["x"])
        for k in ("loss", "delta_norm", "participation", "uplink_bits"):
            assert torch.equal(m[k], mq[k]), k
        assert bool(torch.isnan(mq["weight_sum"]))
        assert float(mq["max_age"]) == float(mq["stale_frac"]) == 0.0


def test_make_async_round_fn_refuses_a_sync_strategy():
    with pytest.raises(ValueError, match="needs an async strategy"):
        make_async_round_fn(lambda p, b: (0, {}), sgd(0.1), sgd_momentum(1.0),
                            RoundConfig(4, 1, aggregation="colrel"))
    with pytest.raises(ValueError, match="do not nest"):
        AsyncRelayStrategy(inner=AsyncRelayStrategy())
    with pytest.raises(ValueError, match="gamma"):
        AsyncRelayStrategy(gamma=0.0)


# -- 3. segmented == monolithic -------------------------------------------------------


def _carry(s, shapes, d):
    st = s.init_state(N, d)
    st["age"] = torch.tensor([0, 2, 1, 0, 3], dtype=torch.int32)
    st["staging"] = flatten.ravel_stacked(tree.map(torch.from_numpy, _stacked(shapes, 9)))
    return st


def _channel(seed=0):
    rng = np.random.default_rng(seed)
    tu, td = _taus(rng, N)
    A = (rng.random((N, N)) * 0.5 + 0.1).astype(np.float32)
    return tu, td, A


@pytest.mark.parametrize("shapes", AWKWARD)
@pytest.mark.parametrize("inner", ["kernel", False])
def test_segmented_equals_monolithic(shapes, inner):
    s = AsyncRelayStrategy(inner=strategies.get("colrel", fused=inner), gamma=0.8)
    deltas = tree.map(torch.from_numpy, _stacked(shapes, 0))
    d = flatten.flat_spec(deltas, stacked=True).d
    tt = [torch.from_numpy(x) for x in _channel()]
    st0 = _carry(s, shapes, d)
    mono_in = tree.map(torch.clone, st0)
    d_mono, st_mono = s.aggregate_tree(deltas, *tt, mono_in, ExecutionContext(n_clients=N))
    seg_in = tree.map(torch.clone, st0)
    d_seg, st_seg = s.aggregate_tree(deltas, *tt, seg_in,
                                     ExecutionContext(n_clients=N, segment_d=1))
    assert torch.equal(st_mono["age"], st_seg["age"])
    assert torch.equal(st_mono["staging"], st_seg["staging"])
    assert st_seg["staging"] is seg_in["staging"]  # written in place
    assert torch.equal(mono_in["staging"], st0["staging"])  # the monolithic path is not
    for a, b in zip(tree.leaves(d_mono), tree.leaves(d_seg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=2e-6)
    # the one pass over the staging buffer equals the per-leaf passes bitwise
    w = torch.rand(N, generator=torch.Generator().manual_seed(1))
    spec = flatten.flat_spec(deltas, stacked=True)
    whole = ops.row_stream(w, st_seg["staging"])
    per_leaf = torch.cat([ops.row_stream(w, st_seg["staging"][:, o:o + z].contiguous())
                          for o, z in zip(spec.offsets, spec.sizes)])
    assert torch.equal(whole, per_leaf)


# -- 4. aggregate_tree against the reference -------------------------------------------


@pytest.mark.parametrize("segment_d", [0, 1])
@pytest.mark.parametrize("inner", ["kernel", "collapse", False])
def test_aggregate_tree_tracks_reference(inner, segment_d):
    shapes = AWKWARD[0]
    s = AsyncRelayStrategy(inner=strategies.get("colrel", fused=inner), gamma=0.8)
    js = JAsyncRelayStrategy(inner=jstrategies.get("colrel", fused=inner), gamma=0.8)
    npt = _stacked(shapes, 0)
    d = sum(int(np.prod(x.shape[1:])) for x in npt.values())
    tu, td, A = _channel(2)
    st = _carry(s, shapes, d)
    jst = {"age": jnp.asarray(st["age"].numpy()), "staging": jnp.asarray(st["staging"].numpy()),
           "inner": ()}
    got, gst = s.aggregate_tree(tree.map(torch.from_numpy, npt), *map(torch.from_numpy,
                                                                     (tu, td, A)),
                                st, ExecutionContext(n_clients=N, segment_d=segment_d))
    want, wst = js.aggregate_tree({k: jnp.asarray(v) for k, v in npt.items()}, jnp.asarray(tu),
                                  jnp.asarray(td), jnp.asarray(A), jst,
                                  JExecutionContext(n_clients=N, segment_d=segment_d))
    _eq(gst["age"], wst["age"])
    _eq(gst["staging"], wst["staging"])
    assert gst["staging"].shape == (N, jflatten.flat_spec(want).d)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


# -- 5. through the trainer, against live reference runs --------------------------------


class _Replay:
    """A channel serving given taus, for the reference trainer."""

    def __init__(self, model, ups, dds):
        self.n, self._model, self.ups, self.dds = model.n, model, ups, dds

    def model_for_round(self, r):
        return self._model

    def tau_for_round(self, r):
        return self.ups[r], self.dds[r]

    def trace(self, start, rounds):
        return self.ups[start:start + rounds], self.dds[start:start + rounds]


def _port_spec(model, how):
    kw = dict(**SPECS[model], channel="markov")
    if how == "mode":
        return ExperimentSpec(**kw, mode="async", async_options=ASYNC_OPTIONS)
    return ExperimentSpec(**kw, strategy="async_colrel", strategy_options=ASYNC_OPTIONS)


def _sampled_taus(exp, rounds):
    """The taus a ``no_trace`` run of ``exp`` draws in its rounds: the
    channel's in-round sampler on the trainer's generator stream."""
    init_fn, sample_fn = exp.trainer.channel.scan_sampler("cpu")
    gen = torch.Generator().manual_seed(exp.spec.seed)
    state = init_fn(gen)
    ups, dds = [], []
    for _ in range(rounds):
        tu, td, state = sample_fn(state, gen)
        ups.append(tu.numpy())
        dds.append(td.numpy())
    return np.stack(ups), np.stack(dds)


@pytest.fixture(scope="module")
def async_reference():
    """(model, taus) -> (init params, TrainLog, round events, final params)
    of the reference's ``mode="async"`` run served ``taus``."""
    cache = {}

    def get(model, ups, dds):
        key = (model, ups.tobytes(), dds.tobytes())
        if key not in cache:
            sink = MemorySink()
            exp = jbuild_experiment(JExperimentSpec(**SPECS[model], mode="async",
                                                    async_options=ASYNC_OPTIONS))
            exp.trainer.metrics = MetricsLogger([sink])
            exp.trainer.log = exp.trainer.metrics.log
            exp.trainer.channel = _Replay(exp.link_model, ups, dds)
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(ROUNDS)
            cache[key] = (init, exp.log, sink.of_kind("round"),
                          jax.tree.map(np.array, exp.trainer.params))
        return cache[key]

    return get


def _check_async_tracks(exp, jref):
    init, jlog, events, jfinal = jref
    log = exp.log
    assert log.rounds == jlog.rounds == list(range(ROUNDS))
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)
    rm = exp.trainer.round_metrics
    assert rm["max_age"] == [e["max_age"] for e in events]
    for k in ("mean_age", "stale_frac"):
        np.testing.assert_allclose(rm[k], [e[k] for e in events], rtol=1e-6, atol=0)
    assert max(exp.trainer.round_metrics["max_age"]) > 0  # ages grew
    for got, want in zip(tree.leaves(exp.params), tree.leaves(jfinal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("how", ["mode", "strategy"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_async_trainer_tracks_reference(async_reference, model, how):
    spec = _port_spec(model, how)
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    assert a.trainer.async_mode and a.trainer.strategy.name == "async_colrel"
    ups, dds = make_channel("markov", a.link_model, seed=spec.seed).trace(0, ROUNDS)
    jref = async_reference(model, ups.astype(np.float32), dds.astype(np.float32))
    for exp, chunk in ((a, 1), (b, 2)):
        exp.trainer.params = params_from_jax(jref[0], "cpu")
        exp.run(ROUNDS, chunk=chunk)
        _check_async_tracks(exp, jref)
    assert b.trainer._scan_fn is not None
    _assert_same(a.trainer, b.trainer)
    _same_metrics(a.trainer, b.trainer)


def test_async_no_trace_tracks_reference(async_reference):
    spec = _port_spec("quadratic", "mode")
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    ups, dds = _sampled_taus(a, ROUNDS)
    jref = async_reference("quadratic", ups, dds)
    for exp, chunk in ((a, 1), (b, ROUNDS)):
        exp.trainer.params = params_from_jax(jref[0], "cpu")
        exp.run(ROUNDS, chunk=chunk, no_trace=True)
        _check_async_tracks(exp, jref)
    _assert_same(a.trainer, b.trainer)
    _same_metrics(a.trainer, b.trainer)


@pytest.mark.parametrize("segment_d", [0, 1])
def test_async_chunked_equals_per_round_cnn(segment_d):
    spec = ExperimentSpec(**SPECS["cifar_cnn"], channel="markov", mode="async",
                          async_options=ASYNC_OPTIONS, strategy_options={"fused": "kernel"},
                          segment_d=segment_d)
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(4)
    b.run(4, chunk=2)
    _assert_same(a.trainer, b.trainer)
    _same_metrics(a.trainer, b.trainer)


# -- 6. the trainer's refusals, and donate=False ------------------------------------------


def test_trainer_async_value_errors():
    spec = ExperimentSpec(model="quadratic")
    with pytest.raises(ValueError, match="already async"):
        build_experiment(spec.replace(strategy="async_colrel", mode="async",
                                      async_options={"gamma": 0.5}), device="cpu")
    with pytest.raises(ValueError, match="requires mode='async'"):
        build_experiment(spec.replace(async_options={"gamma": 0.5}), device="cpu")
    with pytest.raises(ValueError, match="needs the per_client mode"):
        build_experiment(spec.replace(strategy="async_colrel", mode="client_sequential"),
                         device="cpu")


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("path", ["async segmented", "memory kernel", "chunked"])
def test_donate(path, donate):
    """With ``donate=True`` the next round may overwrite what the caller
    read from the trainer (the in-place staging and replay buffers, the
    chunked engine's static carry); with ``donate=False`` it never does,
    and the trajectory is the same."""
    kw = {"async segmented": dict(mode="async", async_options=ASYNC_OPTIONS, segment_d=1,
                                  strategy_options={"fused": "kernel"}),
          "memory kernel": dict(strategy="memory", strategy_options={"fused": "kernel"}),
          "chunked": dict(strategy_options={"fused": "kernel"})}[path]
    spec = ExperimentSpec(model="quadratic", channel="markov", donate=donate, **kw)
    exp, ref = build_experiment(spec, device="cpu"), build_experiment(
        spec.replace(donate=True), device="cpu")
    chunk = 2 if path == "chunked" else 1
    exp.run(2, chunk=chunk)
    held = tree.leaves((exp.trainer.params, exp.trainer.agg_state))
    before = [x.clone() for x in held]
    exp.run(2, chunk=chunk)
    unchanged = all(torch.equal(x, y) for x, y in zip(held, before))
    assert unchanged is not donate
    ref.run(4, chunk=chunk)
    _assert_same(exp.trainer, ref.trainer)

"""The port's chunked multi-round engine and in-scan channel samplers, on
the CPU, mirroring ``tests/test_scan_engine.py``.

1. Within the port, bitwise: ``FLTrainer.run(rounds, chunk=K)`` (K rounds
   a call of :func:`repro_torch.fl.round.make_scan_round_fn`, whose CPU
   version is a plain loop over the round body) reproduces the per-round
   loop's logs, params, server state and strategy state exactly, for every
   ported strategy path; unaligned leading rounds and the tail run per
   round, and a chunk that does not divide the eval cadence runs the whole
   run per round.
2. Against a live reference run: the port's ``run(8, chunk=4)`` against the
   reference's ``FLTrainer.run(8, chunk=4)`` with the same spec, seed and
   init (so the same data, batches, taus and COPT-alpha weights), at the
   tolerances of ``tests/test_torch_slice.py``: participation and
   uplink_bits equal, weight_sum at atol 1e-6, loss at rtol 1e-5.
3. The in-scan samplers: their integer thresholds equal the reference's
   bitwise, and their draws (a ``torch.Generator`` stream, not the
   reference's ``jax.random`` one) hold the model's marginals, the
   reciprocity joint and the Gilbert–Elliott lag-1 autocorrelation over
   4,096 rounds within 6 standard deviations (the bounds of
   ``tests/test_scan_engine.py:367,380``, with the effective sample size of
   a correlated chain where the draws are correlated).
"""

import jax
import numpy as np
import pytest
import torch

from repro.channel import clustered as jclustered
from repro.channel import markov as jmarkov
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro_torch import strategies, tree
from repro_torch.channel import (
    ClusteredMarkovChannel,
    ClusteredStaticChannel,
    MarkovChannel,
    StaticChannel,
    gilbert_elliott,
    gilbert_elliott_clustered,
)
from repro_torch.channel.base import static_scan_sampler
from repro_torch.channel.clustered import (
    _cge_arrays,
    clustered_ge_scan_sampler,
    clustered_static_scan_sampler,
)
from repro_torch.channel.markov import _device_arrays, ge_scan_sampler
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.core.weights import optimize_weights_clustered
from repro_torch.fl.experiment import ExperimentSpec, build_experiment, build_task
from repro_torch.fl.round import METRIC_KEYS, RoundConfig, make_round_fn, make_scan_round_fn
from repro_torch.fl.trainer import FLTrainer
from repro_torch.kernels import launch_counts
from repro_torch.optim import sgd, sgd_momentum
from test_torch_slice import SPECS

DRAWS = 4096


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """Tiny CPU convolutions run fastest and most repeatably on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same(a: FLTrainer, b: FLTrainer):
    """Logs, params, server state and strategy state, bitwise."""
    for field in ("rounds", "loss", "participation", "uplink_bits", "weight_sums"):
        av, bv = getattr(a.log, field), getattr(b.log, field)
        assert len(av) == len(bv), field
        for x, y in zip(av, bv):
            assert x == y or (np.isnan(x) and np.isnan(y)), (field, x, y)
    for state in ("params", "server_state", "agg_state"):
        la, lb = tree.leaves(getattr(a, state)), tree.leaves(getattr(b, state))
        assert len(la) == len(lb), state
        for x, y in zip(la, lb):
            if isinstance(x, torch.Generator):
                assert torch.equal(x.get_state(), y.get_state()), state
            else:
                assert torch.equal(x, y), state
    assert a.round == b.round


# -- 1. chunked == per-round within the port ------------------------------------

PATHS = {
    "colrel kernel": dict(strategy="colrel", strategy_options={"fused": "kernel"}),
    "colrel segmented": dict(strategy="colrel", strategy_options={"fused": "kernel"},
                             segment_d=1),
    "colrel collapse": dict(strategy="colrel", strategy_options={"fused": "collapse"}),
    "colrel faithful": dict(strategy="colrel"),
    "memory kernel": dict(strategy="memory", strategy_options={"fused": "kernel"},
                          channel="markov"),
    "memory segmented": dict(strategy="memory", strategy_options={"fused": "kernel"},
                             channel="markov", segment_d=1),
    "memory plain": dict(strategy="memory", channel="markov"),
    "quantized kernel": dict(strategy="quantized",
                             strategy_options={"codec": "int8", "fused": "kernel"}),
    "quantized segmented": dict(strategy="quantized",
                                strategy_options={"codec": "int8", "fused": "kernel"},
                                segment_d=1),
    "quantized plain": dict(strategy="quantized", strategy_options={"codec": "int8"}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_chunked_equals_per_round_quadratic(path):
    spec = ExperimentSpec(model="quadratic", **PATHS[path])
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(6)
    b.run(6, chunk=3)
    _assert_same(a.trainer, b.trainer)
    assert b.trainer._scan_fn is not None


@pytest.mark.parametrize("path", ["colrel kernel", "memory segmented", "quantized kernel"])
def test_chunked_equals_per_round_cnn(path):
    spec = ExperimentSpec(**SPECS["cifar_cnn"], **PATHS[path])
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec, device="cpu")
    a.run(4)
    b.run(4, chunk=2)
    _assert_same(a.trainer, b.trainer)


def _clustered_trainer(fused, segment_d=0, channel=None):
    cmodel = topology.clustered_blocks(10, 0.5, 5, p_intra=0.8, rho=1.0)
    Ab = optimize_weights_clustered(cmodel, sweeps=10, fine_tune_sweeps=10).Ab
    loss_fn, init, clients, copt, sopt, T, _ = build_task(ExperimentSpec(model="quadratic"),
                                                          cmodel.n, "cpu")
    return FLTrainer(loss_fn, init, None, Ab, clients, copt, sopt, local_steps=T,
                     strategy=strategies.get("clustered", fused=fused),
                     channel=channel or ClusteredStaticChannel(cmodel, seed=3),
                     segment_d=segment_d, device="cpu")


@pytest.mark.parametrize("fused,segment_d", [("kernel", 0), ("kernel", 1), ("collapse", 0),
                                             (False, 0)])
def test_chunked_equals_per_round_clustered(fused, segment_d):
    a, b = _clustered_trainer(fused, segment_d), _clustered_trainer(fused, segment_d)
    a.run(6)
    b.run(6, chunk=3)
    _assert_same(a, b)


def _quadratic_trainer(channel=None):
    spec = ExperimentSpec(model="quadratic", strategy_options={"fused": "kernel"})
    exp = build_experiment(spec, device="cpu")
    if channel is not None:
        exp.trainer.channel = channel
    return exp.trainer


def test_trainer_chunked_matches_loop_static():
    t1, t2 = _quadratic_trainer(), _quadratic_trainer()
    t1.run(14)
    t2.run(14, chunk=4)  # 3 full chunks + a 2-round per-round tail
    _assert_same(t1, t2)
    assert t2.log.rounds == list(range(14))


def test_trainer_chunked_matches_loop_markov_and_resumes_unaligned():
    mk = lambda: MarkovChannel(gilbert_elliott(topology.paper_fig2b(), memory=0.8),
                               seed=1, block=16)
    t1, t2 = _quadratic_trainer(mk()), _quadratic_trainer(mk())
    t1.run(20)
    t2.run(7)  # a per-round prefix ...
    t2.run(13, chunk=5)  # ... then chunked: rounds 7-9 per round, 10-19 in 2 chunks
    _assert_same(t1, t2)


def test_trainer_misaligned_chunk_falls_back_to_per_round():
    t = _quadratic_trainer()
    assert t._effective_chunk(1, 0) == 1
    assert t._effective_chunk(5, 0) == 5
    assert t._effective_chunk(5, 8) == 1  # eval cadence misaligned
    assert t._effective_chunk(5, 10) == 5
    t.eval_fn = lambda p: {"d": float(torch.sum(p["x"] ** 2))}
    t.run(8, chunk=5, eval_every=8)
    assert t._scan_fn is None and t.log.eval_rounds == [7]
    t2 = _quadratic_trainer()
    t2.eval_fn = t.eval_fn
    t2.run(12, chunk=4, eval_every=4)
    assert t2.log.eval_rounds == [3, 7, 11] and t2._scan_fn is not None
    t3 = _quadratic_trainer()
    t3.eval_fn = t.eval_fn
    t3.run(12, eval_every=4)
    assert t3.log.eval_metrics == t2.log.eval_metrics


def test_experiment_spec_chunk_runs_chunked():
    spec = ExperimentSpec(model="quadratic", chunk=3, rounds=6)
    a, b = build_experiment(spec, device="cpu"), build_experiment(spec.replace(chunk=1),
                                                                   device="cpu")
    a.run()
    b.run()
    _assert_same(a.trainer, b.trainer)
    assert a.trainer._scan_fn is not None and b.trainer._scan_fn is None


def _scan_inputs(rc, K, seed=0):
    """A 3-client quadratic task with K rounds of batches and taus."""
    rng = np.random.default_rng(seed)
    H = torch.as_tensor(np.diag(np.linspace(1.0, 4.0, 6)), dtype=torch.float32)

    def loss_fn(params, batch):
        r = params["x"] - batch["t"][0]
        return 0.5 * r @ (H @ r), {}

    batches = {"t": torch.as_tensor(rng.normal(size=(K, rc.n_clients, rc.local_steps, 1, 6)),
                                    dtype=torch.float32)}
    tau_up = torch.as_tensor(rng.random((K, rc.n_clients)) < 0.7, dtype=torch.float32)
    tau_dd = torch.as_tensor(rng.random((K, rc.n_clients, rc.n_clients)) < 0.6,
                             dtype=torch.float32)
    A = torch.as_tensor(rng.random((rc.n_clients, rc.n_clients)) * 0.5, dtype=torch.float32)
    return loss_fn, batches, tau_up, tau_dd, A


@pytest.mark.parametrize("aggregation", ["colrel", "memory", "quantized"])
def test_scan_round_fn_equals_sequential_rounds(aggregation):
    """The engine itself: K rounds a call against K calls of the round body
    on the same inputs, bitwise, metrics stacked ``(K,)``; the carry it
    returns is its static buffers, reused by the next call of the same
    signature, and a longer chunk builds new ones."""
    rc = RoundConfig(n_clients=3, local_steps=2, aggregation=aggregation)
    K = 4
    loss_fn, batches, tau_up, tau_dd, A = _scan_inputs(rc, K)
    copt, sopt = sgd(0.1), sgd_momentum(1.0, beta=0.9)
    strategy = rc.resolve_strategy()
    round_fn = make_round_fn(loss_fn, copt, sopt, rc)
    p, ss, ag = {"x": torch.zeros(6)}, sopt.init({"x": torch.zeros(6)}), strategy.init_state(3, 6)
    rows = []
    for i in range(K):
        p, ss, ag, m = round_fn(p, ss, ag, {"t": batches["t"][i]}, tau_up[i], tau_dd[i], A)
        rows.append([m[k] for k in METRIC_KEYS])
    scan = make_scan_round_fn(loss_fn, copt, sopt, rc)
    p0 = {"x": torch.zeros(6)}
    sp, sss, sag, metrics = scan(p0, sopt.init(p0), strategy.init_state(3, 6), batches,
                                 tau_up, tau_dd, A)
    assert torch.equal(sp["x"], p["x"]) and torch.equal(sss["m"]["x"], ss["m"]["x"])
    assert int(sss["step"]) == K and torch.equal(p0["x"], torch.zeros(6))
    for x, y in zip(tree.leaves(sag), tree.leaves(ag)):
        assert (torch.equal(x.get_state(), y.get_state()) if isinstance(x, torch.Generator)
                else torch.equal(x, y))
    for j, k in enumerate(METRIC_KEYS):
        assert metrics[k].shape == (K,)
        want = torch.stack([r[j] for r in rows])
        assert torch.equal(metrics[k], want) or (k == "weight_sum" and
                                                 bool(torch.isnan(metrics[k]).all()))
    slot = scan._slot
    sp2, *_ = scan(sp, sss, sag, {"t": batches["t"][:2]}, tau_up[:2], tau_dd[:2], A)
    assert scan._slot is slot and sp2["x"] is sp["x"]
    scan({"x": torch.zeros(6)}, sopt.init(p0), strategy.init_state(3, 6),
         {"t": torch.cat([batches["t"]] * 2)}, torch.cat([tau_up] * 2),
         torch.cat([tau_dd] * 2), A)
    assert scan._slot is not slot and scan._slot.capacity == 2 * K


def test_scan_round_fn_with_in_scan_sampler_runs():
    """The sampled variant: carry = (params, server_state, agg_state,
    channel_state, gen); the gate state is advanced in place and a second
    call continues the chain."""
    model = topology.paper_fig2b()
    init_fn, sample_fn = ge_scan_sampler(gilbert_elliott(model, memory=0.8), "cpu")
    rc = RoundConfig(n_clients=10, local_steps=2)
    K = 5
    loss_fn, batches, _, _, A = _scan_inputs(rc, K)
    sopt = sgd_momentum(1.0, beta=0.9)
    scan = make_scan_round_fn(loss_fn, sgd(0.05), sopt, rc, channel_sampler=sample_fn)
    gen = torch.Generator().manual_seed(3)
    state = init_fn(gen)
    p = {"x": torch.zeros(6)}
    start = gen.get_state()
    p2, ss, ag, state2, gen2, metrics = scan(p, sopt.init(p), (), batches, state, gen, A)
    assert gen2 is gen and not torch.equal(gen.get_state(), start)
    assert state2.shape == state.shape == (10 + 45,) and state2.dtype == torch.bool
    assert bool(torch.isfinite(metrics["loss"]).all()) and metrics["participation"].shape == (K,)
    assert all(0 <= v <= 10 for v in metrics["participation"].tolist())
    # the same stream drawn round by round outside the engine
    gen_b = torch.Generator().manual_seed(3)
    st_b = init_fn(gen_b)
    ups = [sample_fn(st_b, gen_b)[0].sum() for _ in range(K)]
    assert torch.equal(torch.stack(ups), metrics["participation"])
    scan(p2, ss, ag, batches, state2, gen2, A)


# -- 2. against a live reference run ----------------------------------------------

@pytest.fixture(scope="module")
def chunked_reference():
    """Model kind -> (init params, TrainLog) of the reference's
    ``run(8, chunk=4)`` with the faithful colrel path."""
    cache = {}

    def get(model):
        if model not in cache:
            exp = jbuild_experiment(JExperimentSpec(**SPECS[model], strategy="colrel",
                                                    strategy_options={"fused": False}))
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(8, chunk=4)
            cache[model] = (init, exp.log)
        return cache[model]

    return get


@pytest.mark.parametrize("fused", [False, "kernel"])
@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_chunked_port_tracks_chunked_reference(chunked_reference, model, fused):
    init, jlog = chunked_reference(model)
    exp = build_experiment(ExperimentSpec(**SPECS[model], strategy="colrel",
                                          strategy_options={"fused": fused}), device="cpu")
    exp.trainer.params = params_from_jax(init, "cpu")
    log = exp.run(8, chunk=4)
    assert exp.trainer._scan_fn is not None
    assert log.rounds == jlog.rounds == list(range(8))
    assert log.participation == jlog.participation
    assert log.uplink_bits == jlog.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jlog.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jlog.loss, rtol=1e-5, atol=0)


# -- 3. the in-scan samplers ----------------------------------------------------------


def _draw(init_fn, sample_fn, rounds=DRAWS, seed=0):
    gen = torch.Generator().manual_seed(seed)
    state = init_fn(gen)
    ups, dds = [], []
    for _ in range(rounds):
        tu, td, state = sample_fn(state, gen)
        ups.append(tu)
        dds.append(td)
    return torch.stack(ups).double().numpy(), torch.stack(dds).double().numpy()


def _dense_model():
    return topology.fully_connected(8, 0.6, p_c=0.5, rho=0.5)


def _block_model():
    return topology.clustered_blocks(12, 0.6, 4, p_intra=0.5, rho=0.5)


def _ge_sd(lam, count):
    """Standard deviation of a mean over ``count`` draws of chains with
    memory ``lam``: the effective sample size of an AR(1) chain."""
    return np.sqrt(0.25 / (count * (1 - lam) / (1 + lam)))


def test_ge_thresholds_equal_the_reference():
    params = gilbert_elliott(_dense_model(), memory=(0.7, 0.9))
    jparams = jmarkov.gilbert_elliott(_dense_model(), memory=(0.7, 0.9))
    mine, ref = _device_arrays(params, "cpu"), jmarkov._device_arrays(jparams)
    for k in ("t_g_up", "t_b_up", "t_g_dd", "t_b_dd", "t_q_up", "t_qij", "t_qji", "t_e",
              "t_mid", "pair_lane"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]).astype(np.int64),
                                      err_msg=k)
    for k in ("pi_up", "pi_dd"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_cge_thresholds_equal_the_reference():
    model = _block_model()
    params = gilbert_elliott_clustered(model, memory=0.8)
    jparams = jclustered.gilbert_elliott_clustered(model, memory=0.8)
    mine, ref = _cge_arrays(params, "cpu"), jclustered._cge_arrays(jparams)
    assert sorted(mine) == sorted(ref)
    for k in mine:
        want = np.asarray(ref[k])
        want = want if want.dtype == np.float32 else want.astype(np.int64)
        np.testing.assert_array_equal(mine[k].numpy(), want, err_msg=k)


def test_static_scan_sampler_matches_marginals():
    m = _dense_model()
    ups, dds = _draw(*static_scan_sampler(m, "cpu"))
    off = ~np.eye(8, dtype=bool)
    sd_up, sd_dd = np.sqrt(0.25 / (DRAWS * 8)), np.sqrt(0.25 / (DRAWS * 56))
    assert abs(ups.mean() - m.p.mean()) < 6 * sd_up
    assert abs(dds.mean(0)[off].mean() - m.P[off].mean()) < 6 * sd_dd
    joint = (dds * np.swapaxes(dds, 1, 2)).mean(0)[off].mean()
    assert abs(joint - m.E[off].mean()) < 6 * sd_dd
    np.testing.assert_array_equal(dds[:, np.arange(8), np.arange(8)], 1.0)
    # i.i.d.: no lag-1 memory
    assert abs(_lag1(ups)) < 6 * np.sqrt(1.0 / (DRAWS * 8))


def _lag1(x: np.ndarray) -> float:
    """Lag-1 autocorrelation of each column's series, averaged."""
    x = x - x.mean(0)
    return float(np.mean((x[1:] * x[:-1]).mean(0) / np.maximum(x.var(0), 1e-12)))


def test_ge_scan_sampler_matches_marginals_and_memory():
    m = _dense_model()
    lam = 0.8
    params = gilbert_elliott(m, memory=lam)
    ups, dds = _draw(*ge_scan_sampler(params, "cpu"))
    off = ~np.eye(8, dtype=bool)
    assert abs(ups.mean() - m.p.mean()) < 6 * _ge_sd(lam, DRAWS * 8)
    assert abs(dds.mean(0)[off].mean() - m.P[off].mean()) < 6 * _ge_sd(lam, DRAWS * 28)
    joint = (dds * np.swapaxes(dds, 1, 2)).mean(0)[off].mean()
    assert abs(joint - m.E[off].mean()) < 6 * _ge_sd(lam, DRAWS * 28)
    np.testing.assert_array_equal(dds[:, np.arange(8), np.arange(8)], 1.0)
    # lag-1 autocorrelation of tau_up: q (1 - pi) lam / (1 - p); Bartlett's
    # variance of a lag-1 estimate, (1 + lam^2) / ((1 - lam^2) N), per client
    want = params.lag1_uplink().mean()
    sd = np.sqrt((1 + lam**2) / ((1 - lam**2) * DRAWS * 8))
    assert want > 0.5 and abs(_lag1(ups) - want) < 6 * sd


def _block_off(m):
    return ~np.eye(m, dtype=bool)


def test_clustered_static_scan_sampler_matches_marginals():
    model = _block_model()
    ups, tbs = _draw(*clustered_static_scan_sampler(model, "cpu"))
    C, m = model.C, model.m
    assert tbs.shape == (DRAWS, C, m, m)
    off = _block_off(m)
    pairs = C * m * (m - 1)
    assert abs(ups.mean() - model.p.mean()) < 6 * np.sqrt(0.25 / (DRAWS * model.n))
    assert abs(tbs.mean(0)[:, off].mean() - model.Pb[:, off].mean()) < 6 * np.sqrt(
        0.25 / (DRAWS * pairs))
    joint = (tbs * np.swapaxes(tbs, -1, -2)).mean(0)[:, off].mean()
    assert abs(joint - model.Eb[:, off].mean()) < 6 * np.sqrt(0.25 / (DRAWS * pairs))
    np.testing.assert_array_equal(tbs[:, :, np.arange(m), np.arange(m)], 1.0)


def test_clustered_ge_scan_sampler_matches_marginals_and_memory():
    model = _block_model()
    lam = 0.8
    params = gilbert_elliott_clustered(model, memory=lam)
    ups, tbs = _draw(*clustered_ge_scan_sampler(params, "cpu"))
    C, m = model.C, model.m
    off = _block_off(m)
    pairs = C * m * (m - 1) // 2
    assert abs(ups.mean() - model.p.mean()) < 6 * _ge_sd(lam, DRAWS * model.n)
    assert abs(tbs.mean(0)[:, off].mean() - model.Pb[:, off].mean()) < 6 * _ge_sd(
        lam, DRAWS * pairs)
    joint = (tbs * np.swapaxes(tbs, -1, -2)).mean(0)[:, off].mean()
    assert abs(joint - model.Eb[:, off].mean()) < 6 * _ge_sd(lam, DRAWS * pairs)
    np.testing.assert_array_equal(tbs[:, :, np.arange(m), np.arange(m)], 1.0)
    # tightest fit (pi_up = p): the uplink's lag-1 autocorrelation is lam
    sd = np.sqrt((1 + lam**2) / ((1 - lam**2) * DRAWS * model.n))
    assert abs(_lag1(ups) - lam) < 6 * sd


NO_TRACE_CHANNELS = {
    "static": lambda: StaticChannel(topology.paper_fig2b(), seed=0),
    "markov": lambda: MarkovChannel(gilbert_elliott(topology.paper_fig2b(), memory=0.8), seed=0),
}


@pytest.mark.parametrize("channel", sorted(NO_TRACE_CHANNELS))
def test_no_trace_runs_dense_channels(channel):
    """``no_trace=True`` draws the taus inside the round: any chunk size,
    the last chunk shorter; the same seed gives the same run whatever the
    chunking."""
    t1 = _quadratic_trainer(NO_TRACE_CHANNELS[channel]())
    t1.run(7, chunk=3, no_trace=True)
    assert t1.log.rounds == list(range(7)) and bool(torch.isfinite(t1.params["x"]).all())
    assert all(0 <= v <= 10 and v == int(v) for v in t1.log.participation)
    t2 = _quadratic_trainer(NO_TRACE_CHANNELS[channel]())
    t2.run(7, chunk=7, no_trace=True)
    _assert_same(t1, t2)


@pytest.mark.parametrize("kind", ["static", "markov"])
def test_no_trace_runs_clustered_channels(kind):
    cmodel = topology.clustered_blocks(10, 0.5, 5, p_intra=0.8, rho=1.0)
    channel = (ClusteredStaticChannel(cmodel, seed=0) if kind == "static" else
               ClusteredMarkovChannel(gilbert_elliott_clustered(cmodel, memory=0.8), seed=0))
    t = _clustered_trainer("kernel", channel=channel)
    t.run(6, chunk=3, no_trace=True)
    assert t.log.rounds == list(range(6)) and bool(torch.isfinite(t.params["x"]).all())
    assert all(0 <= v <= 10 for v in t.log.participation)


def test_launch_counts_read_every_wrapper_without_resetting():
    from repro_torch.kernels import fused_aggregate as fa

    counts = launch_counts()
    assert {"fused_aggregate_cuda", "row_stream_segments_cuda", "fused_memory_update_cuda",
            "memory_stream_segments_cuda", "fused_dequant_aggregate_cuda",
            "block_fused_aggregate_cuda", "block_row_stream_segments_cuda", "relay_mix_cuda",
            "block_relay_mix_cuda", "flash_attention_cuda", "ssd_scan_cuda"} <= set(counts)
    before = fa.fused_aggregate_cuda.launches
    fa.fused_aggregate_cuda.launches = before + 2
    try:
        assert launch_counts()["fused_aggregate_cuda"] == before + 2
    finally:
        fa.fused_aggregate_cuda.launches = before


def test_no_trace_needs_a_sampler():
    t = _quadratic_trainer()
    t.channel = type("Plain", (), {"n": 10})()
    with pytest.raises(ValueError, match="scan_sampler"):
        t.run(2, no_trace=True)

"""The port's telemetry on the CPU, against the reference and within itself.

1. Against the reference, on the same numpy inputs: the streak recurrence,
   and the instrumented round's participation vector, per-client bits
   (colrel's 32 bits a coordinate, int8's and topk's rates at several flat
   dims) and streak equal exactly; ``weight_drift`` within 1e-6;
   ``config_digest`` of the same spec dict is the reference's.  A
   telemetry-on ``build_experiment`` run (quadratic and the reduced CIFAR
   CNN, the static channel, 4 rounds in chunks of 2) tracks a live
   reference telemetry run with the reference's init: participation,
   ``uplink_bits``, the participation and bits vectors and the streak
   equal; ``weight_sum`` and ``weight_drift`` at atol 1e-6 and the loss at
   rtol 1e-5, the tolerances of ``test_torch_slice.py``.
2. Within the port: telemetry on is bitwise telemetry off (params, server
   and strategy state, every scalar stream) per round, chunked and with
   ``no_trace``, for every strategy of the conformance fixture; per round
   equals chunked with the streak; the vectors reduce to the scalar
   streams; ``no_trace`` draws the same per round and chunked.
3. The host tier: one cast path for both shapes, round events with a
   monotonic ``seq``, ``health.nan``, the JSONL and CSV sinks, the
   end-of-run client summary and ``vectors.npz``, the manifest, the
   experiment's ``metrics_dir`` wiring.
4. The timing tier: the throughput meter, the capture tracker's
   ``health.recompile`` after a round's first capture, the profile
   window's state machine and a Chrome trace written by a
   ``profile_dir`` run, ``log_every``'s stderr line, and ``verbose``'s
   eval line.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro import strategies as jstrategies
from repro.fl.experiment import ExperimentSpec as JExperimentSpec
from repro.fl.experiment import build_experiment as jbuild_experiment
from repro.telemetry import config_digest as jconfig_digest
from repro.telemetry import instrument_round_fn as jinstrument_round_fn
from repro.telemetry import update_streak as jupdate_streak
from repro_torch import strategies
from repro_torch.convert import params_from_jax
from repro_torch.fl.experiment import ExperimentSpec, build_experiment
from repro_torch.telemetry import (
    VECTOR_METRICS,
    CompileTracker,
    CsvSummarySink,
    JsonlSink,
    MemorySink,
    MetricsLogger,
    ProfileWindow,
    RunManifest,
    ThroughputMeter,
    config_digest,
    git_sha,
    init_streak,
    instrument_round_fn,
    update_streak,
)
from test_torch_slice import SPECS


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _expected_streak(part: np.ndarray) -> np.ndarray:
    """The outage-streak recurrence rolled over an (R, n) participation
    history on the host."""
    out = np.zeros(part.shape, np.int32)
    age = np.zeros(part.shape[1], np.int32)
    for r in range(part.shape[0]):
        age = np.where(part[r] > 0, 0, age + 1)
        out[r] = age
    return out


# -- 1. against the reference -------------------------------------------------------


def test_streak_recurrence_equals_reference():
    taus = (np.random.default_rng(0).random((20, 7)) < 0.4).astype(np.float32)
    s, js = init_streak(7), jnp.zeros((7,), jnp.int32)
    assert s.dtype == torch.int32 and s.shape == (7,)
    for tau in taus:
        s, js = update_streak(s, torch.as_tensor(tau)), jupdate_streak(js, jnp.asarray(tau))
        assert s.dtype == torch.int32
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(s.numpy(), _expected_streak(taus)[-1])


@pytest.mark.parametrize("d", [16, 1000, 272282])
@pytest.mark.parametrize("strategy, options", [("colrel", {}),
                                               ("quantized", {"codec": "int8"}),
                                               ("quantized", {"codec": "topk"})])
def test_instrumented_vectors_equal_reference(strategy, options, d):
    """The wrapper alone, around a base round that returns the given
    ``weight_sum``: the same taus give the same vectors."""
    rng = np.random.default_rng(d)
    tau = (rng.random(10) < 0.5).astype(np.float32)
    streak = rng.integers(0, 5, 10).astype(np.int32)
    w = np.float32(rng.normal(1.0, 0.1))

    def base(p, ss, ag, b, tu, td, A):
        return p, ss, ag, {"weight_sum": b}
    base.metric_keys = ("weight_sum",)

    ours = instrument_round_fn(base, strategies.get(strategy, **options).wire_bits_per_coord)
    theirs = jinstrument_round_fn(base, jstrategies.get(strategy, **options).wire_bits_per_coord)
    *_, st, m = ours({"x": torch.zeros(d)}, (), (), torch.tensor(w), torch.as_tensor(tau),
                     None, None, torch.as_tensor(streak))
    *_, jst, jm = theirs({"x": jnp.zeros(d)}, (), (), jnp.asarray(w), jnp.asarray(tau),
                         None, None, jnp.asarray(streak))
    for name in VECTOR_METRICS:
        assert m[name].numpy().dtype == np.asarray(jm[name]).dtype, name
        np.testing.assert_array_equal(m[name].numpy(), np.asarray(jm[name]), err_msg=name)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_allclose(float(m["weight_drift"]), float(jm["weight_drift"]), atol=1e-6)
    assert ours.metric_keys == ("weight_sum", "weight_drift")


def test_config_digest_equals_reference():
    spec = dict(model="quadratic", strategy="memory", channel="markov", chunk=4,
                strategy_options={"fused": "kernel"}, metrics_dir="m", ckpt_every=4)
    ours = dataclasses.asdict(ExperimentSpec(**spec))
    theirs = dataclasses.asdict(JExperimentSpec(**spec))
    assert config_digest(ours) == jconfig_digest(theirs)
    cfg = {"b": 1, "a": [1, 2], "arr": np.arange(3), "f": np.float32(0.5), "t": (1, "x")}
    assert config_digest(cfg) == jconfig_digest(cfg)


@pytest.fixture(scope="module")
def telemetry_reference():
    cache = {}

    def get(model):
        if model not in cache:
            exp = jbuild_experiment(JExperimentSpec(**SPECS[model], strategy="colrel",
                                                    strategy_options={"fused": False},
                                                    telemetry=True))
            init = jax.tree.map(np.array, exp.trainer.params)
            exp.run(4, chunk=2)
            cache[model] = (init, exp.trainer)
        return cache[model]

    return get


@pytest.mark.parametrize("model", ["quadratic", "cifar_cnn"])
def test_telemetry_run_tracks_reference(telemetry_reference, model):
    init, jt = telemetry_reference(model)
    exp = build_experiment(ExperimentSpec(**SPECS[model], strategy="colrel",
                                          strategy_options={"fused": "kernel"},
                                          telemetry=True), device="cpu")
    exp.trainer.params = params_from_jax(init, "cpu")
    log = exp.run(4, chunk=2)
    t = exp.trainer
    assert log.rounds == jt.log.rounds == list(range(4))
    assert log.participation == jt.log.participation
    assert log.uplink_bits == jt.log.uplink_bits
    np.testing.assert_allclose(log.weight_sums, jt.log.weight_sums, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.round_metrics["weight_drift"],
                               [abs(w - 1.0) for w in jt.log.weight_sums], rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.loss, jt.log.loss, rtol=1e-5, atol=0)
    for name in VECTOR_METRICS:
        ours, theirs = t.metrics.vector(name), jt.metrics.vector(name)
        assert ours.shape == theirs.shape == (4, 10) and ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    np.testing.assert_array_equal(t._streak.numpy(), np.asarray(jt._streak))


# -- 2. within the port ------------------------------------------------------------------

TEL_MODES = {"per_round": dict(chunk=1), "chunked": dict(chunk=3),
             "no_trace": dict(chunk=3, no_trace=True)}


@pytest.mark.parametrize("mode", list(TEL_MODES))
@pytest.mark.parametrize("strategy", ["colrel", "memory", "quantized", "clustered",
                                      "async_colrel"])
def test_instrumented_round_is_inert(strategy, mode):
    """Telemetry on against off: the same trajectory and scalar streams,
    bitwise; the vectors reduce to the scalars and follow the recurrence."""
    base, tel = conf.make_trainer(strategy), conf.make_trainer(strategy, telemetry=True)
    base.run(6, **TEL_MODES[mode])
    tel.run(6, **TEL_MODES[mode])
    for field in ("rounds", "loss", "participation", "uplink_bits", "weight_sums"):
        a, b = getattr(base.log, field), getattr(tel.log, field)
        assert all(x == y or (np.isnan(x) and np.isnan(y)) for x, y in zip(a, b)), field
    for k, v in base.round_metrics.items():
        np.testing.assert_array_equal(v, tel.round_metrics[k], err_msg=k)
    for name in ("params", "server_state", "agg_state"):
        conf._same_leaves(getattr(base, name), getattr(tel, name), name)
    part = tel.metrics.vector("client_participation")
    bits = tel.metrics.vector("client_uplink_bits")
    streak = tel.metrics.vector("outage_streak")
    assert part.shape == bits.shape == streak.shape == (6, conf.N)
    assert part.dtype == bits.dtype == np.float32 and streak.dtype == np.int32
    assert set(np.unique(part)) <= {0.0, 1.0}
    np.testing.assert_array_equal(part.sum(axis=1), tel.log.participation)
    np.testing.assert_allclose(bits.sum(axis=1), tel.log.uplink_bits, rtol=1e-6)
    np.testing.assert_array_equal(streak, _expected_streak(part))
    np.testing.assert_array_equal(tel._streak.numpy(), streak[-1])
    assert base.metrics.vector("outage_streak") is None and base._streak is None


@pytest.mark.parametrize("strategy", ["colrel", "memory", "async_colrel"])
def test_per_round_equals_chunked_with_the_streak(strategy):
    loop, chunked = (conf.make_trainer(strategy, telemetry=True) for _ in range(2))
    loop.run(7)
    chunked.run(7, chunk=3)  # the chunk path and a per-round tail
    conf.assert_same_run(loop, chunked)
    a, b = (conf.make_trainer(strategy, telemetry=True) for _ in range(2))
    a.run(6, chunk=1, no_trace=True)
    b.run(6, chunk=3, no_trace=True)
    conf.assert_same_run(a, b)


# -- 3. the host tier ---------------------------------------------------------------------


def test_log_rounds_one_cast_for_both_shapes():
    vals = np.asarray([0.1, 2.5, np.float32(1) / 3], np.float32)
    logger = MetricsLogger()
    logger.log_rounds(0, {"loss": torch.tensor(vals[0])})  # per round: 0-d
    logger.log_rounds(1, {"loss": torch.as_tensor(vals[1:])}, k=2)  # a chunk: (2,)
    assert logger.log.loss == np.asarray(vals, np.float64).tolist()
    assert logger.log.rounds == [0, 1, 2] and logger.round_metrics["loss"] == logger.log.loss


def test_round_events_seq_and_health_nan():
    sink = MemorySink()
    logger = MetricsLogger([sink])
    logger.log_rounds(0, {"loss": torch.tensor(1.0), "participation": torch.tensor(3.0),
                          "delta_norm": torch.tensor(0.5)})
    logger.log_eval(0, {"acc": 0.5})
    logger.log_timing(0, 4, 2.0)
    logger.log_rounds(4, {"loss": torch.tensor([1.0, float("nan")])}, k=2)
    seqs = [e["seq"] for e in sink.events]
    assert seqs == list(range(len(seqs)))
    ev = sink.of_kind("round")[0]
    assert ev == {"event": "round", "seq": 0, "round": 0, "loss": 1.0, "participation": 3.0,
                  "delta_norm": 0.5}
    assert sink.of_kind("timing")[0]["rounds_per_sec"] == 2.0
    nan_ev = sink.of_kind("health.nan")
    assert len(nan_ev) == 1 and nan_ev[0]["round"] == 5
    assert len(logger.log.loss) == 3 and np.isnan(logger.log.loss[-1])


def test_jsonl_csv_summary_and_vectors(tmp_path):
    sink = MemorySink()
    logger = MetricsLogger([sink, JsonlSink(tmp_path / "events.jsonl", buffer=2),
                            CsvSummarySink(tmp_path / "rounds.csv")])
    part = np.asarray([[1, 0], [0, 0], [1, 1]], np.float32)
    for r in range(3):
        logger.log_rounds(r, {
            "loss": torch.tensor(1.5), "participation": torch.tensor(part[r].sum()),
            "uplink_bits": torch.tensor(part[r].sum() * 8), "weight_sum": torch.tensor(1.0),
            "weight_drift": torch.tensor(0.0),
            "client_participation": torch.as_tensor(part[r]),
            "client_uplink_bits": torch.as_tensor(part[r] * 32.0),
            "outage_streak": torch.as_tensor(_expected_streak(part)[r])})
    p = logger.save_vectors(tmp_path / "vectors.npz")
    logger.close()
    summ = sink.of_kind("summary.clients")[0]
    assert summ["participation_count"] == [2, 1] and summ["outage_streak_max"] == [1, 2]
    assert summ["uplink_bits_total"] == [64.0, 32.0] and summ["rounds"] == 3
    np.testing.assert_array_equal(np.load(p)["client_participation"], part)
    events = JsonlSink.load(tmp_path / "events.jsonl")
    assert [e["round"] for e in events if e["event"] == "round"] == [0, 1, 2]
    assert events[-1]["event"] == "summary.clients"
    lines = (tmp_path / "rounds.csv").read_text().strip().splitlines()
    assert lines[0] == "round,loss,participation,uplink_bits,weight_sum,weight_drift"
    assert lines[1] == "0,1.5,1.0,8.0,1.0,0.0"
    assert MetricsLogger().save_vectors(tmp_path / "none.npz") is None


def test_manifest_fields_and_write(tmp_path):
    cfg = {"b": 1, "a": [1, 2], "arr": np.arange(3), "f": np.float32(0.5)}
    m = RunManifest.collect(cfg, device="cpu", strategy="colrel", channel="markov",
                            codec="int8", n_clients=4)
    assert m.backend == "cpu" and m.torch_version == torch.__version__
    assert m.cuda_version == torch.version.cuda and "gpu" not in m.extra
    assert m.config_digest == config_digest(cfg)
    loaded = json.loads(m.write(tmp_path).read_text())
    assert loaded["strategy"] == "colrel" and loaded["extra"]["n_clients"] == 4
    assert git_sha(str(pathlib.Path(__file__).parent)) is not None


def test_experiment_metrics_dir_wiring(tmp_path):
    exp = build_experiment(ExperimentSpec(model="quadratic", topology="fig2a", rounds=4,
                                          chunk=2, metrics_dir=str(tmp_path / "m")),
                           device="cpu")
    assert exp.trainer.telemetry and exp.manifest is not None
    assert (tmp_path / "m" / "manifest.json").exists()
    exp.run()
    exp.close()
    events = JsonlSink.load(tmp_path / "m" / "events.jsonl")
    assert {"round", "timing", "summary.clients"} <= {e["event"] for e in events}
    assert len([e for e in events if e["event"] == "round"]) == 4
    assert set(np.load(tmp_path / "m" / "vectors.npz").files) == set(VECTOR_METRICS)
    man = json.loads((tmp_path / "m" / "manifest.json").read_text())
    assert man["config"]["model"] == "quadratic" and man["backend"] == "cpu"
    assert man["config_digest"] == config_digest(man["config"])


# -- 4. the timing tier -------------------------------------------------------------------


def test_throughput_meter():
    meter = ThroughputMeter()
    meter.start()
    dt = meter.stop(4, fence={"x": torch.ones(3)})
    assert dt > 0 and meter.total_rounds == 4
    assert meter.rounds_per_sec() == pytest.approx(4 / dt)
    with pytest.raises(RuntimeError):
        meter.stop(1)


def test_capture_tracker_and_health_recompile():
    class Engine:
        stats: dict = {}

    eng = Engine()
    tracker = CompileTracker()
    tracker.register("scan_fn", eng)
    assert tracker.check() == {}
    eng.stats = {"captures": 1}
    assert tracker.check() == {"scan_fn": 1} and tracker.check() == {}
    # the trainer: the first capture of an engine is expected, a later one
    # (a new carry signature, a longer chunk) is a health.recompile event
    sink = MemorySink()
    t = conf.make_trainer(metrics=MetricsLogger([sink]))
    eng2 = Engine()
    t.compiles.register("scan_fn", eng2)
    eng2.stats = {"captures": 1}
    t._log_compile_growth(3)
    eng2.stats = {"captures": 2}
    t._log_compile_growth(7)
    assert [(e["round"], e["fn"], e["growth"]) for e in sink.of_kind("health.recompile")] == [
        (7, "scan_fn", 1)]


def test_trainer_emits_timing_and_logs_throughput(capsys):
    sink = MemorySink()
    t = conf.make_trainer(telemetry=True, metrics=MetricsLogger([sink]))
    t.run(4, chunk=2, log_every=2)
    timing = sink.of_kind("timing")
    assert [e["round0"] for e in timing] == [0, 2]
    assert all(e["rounds"] == 2 and e["seconds"] > 0 for e in timing)
    assert t.meter.total_rounds == 4 and t.compiles.compile_counts() == {"scan_fn": 0}
    assert sink.of_kind("health.recompile") == []
    err = capsys.readouterr().err
    assert "[telemetry] round 2:" in err and "[telemetry] round 4:" in err


@pytest.mark.parametrize("chunk", [1, 2])
def test_verbose_eval_prints_the_eval_metrics(capsys, chunk):
    """``verbose=True`` with an eval cadence prints each eval round's loss
    and the eval metrics that ``log_eval`` recorded."""
    exp = build_experiment(ExperimentSpec(model="quadratic", rounds=4), device="cpu")
    exp.run(chunk=chunk, eval_every=2, verbose=True)
    out = capsys.readouterr().out.splitlines()
    assert exp.log.eval_rounds == [1, 3]
    want = [f"  round {r + 1:4d}  loss={exp.log.loss[r]:.4f}  dist2={em['dist2']:.4f}"
            for r, em in zip(exp.log.eval_rounds, exp.log.eval_metrics)]
    assert out == want


def test_profile_window(tmp_path, monkeypatch):
    calls = []

    class FakeProfile:
        def __init__(self, activities):
            calls.append("new")

        def __enter__(self):
            calls.append("start")

        def __exit__(self, *exc):
            calls.append("stop")

        def export_chrome_trace(self, path):
            calls.append("export")
            pathlib.Path(path).write_text("{}")

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    w = ProfileWindow(str(tmp_path / "prof"), start=4, rounds=4)
    assert not w.maybe_start(0) and calls == []
    assert w.maybe_start(4) and calls == ["new", "start"]
    assert w.maybe_start(6) and calls == ["new", "start"]  # no double start
    assert not w.maybe_stop(6)  # the window ends at round 8
    assert w.maybe_stop(8) and calls[-2:] == ["stop", "export"]
    assert w.trace_path == tmp_path / "prof" / "trace.json" and w.trace_path.exists()
    assert not w.maybe_start(12)  # one window a run
    w2 = ProfileWindow(str(tmp_path / "prof2"), start=0, rounds=2)
    w2.maybe_start(0)
    w2.close()  # a window left open at the end
    assert calls[-2:] == ["stop", "export"] and w2.done
    with pytest.raises(ValueError):
        ProfileWindow(str(tmp_path), rounds=0)


def test_profile_dir_run_writes_a_trace(tmp_path):
    exp = build_experiment(ExperimentSpec(model="quadratic", rounds=4, chunk=2,
                                          profile_dir=str(tmp_path / "p"), profile_start=2,
                                          profile_rounds=2), device="cpu")
    exp.run()
    w = exp.trainer.profile
    assert w.done and not w.active
    trace = json.loads(w.trace_path.read_text())
    assert trace["traceEvents"]

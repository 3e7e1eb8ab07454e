"""Kill/resume of the port's training run on the CPU, bitwise within the port.

1. The conformance matrix's counterpart: every registered port strategy x
   {per_round, chunked, no_trace, async}.  A run saves at round 3 through
   the background writer and goes on to 6; a fresh trainer restores the
   round-3 checkpoint and continues to 6.  Every TrainLog stream, every
   scalar the round returned, params, server state, strategy state (the
   codecs' generators by their state) and the ``no_trace`` carry equal the
   uninterrupted run's bitwise.  The channel's block is 4 rounds, so the
   resume regenerates a block in its middle and then crosses a refill.
2. The reference's ``tests/test_resume.py`` cases: resume from a directory's
   latest checkpoint (chunked, so the checkpoint is taken after the next
   chunk's batches were stacked), ``ckpt_keep`` retention, the final-only
   save, a cadence that is not a multiple of the chunk, telemetry's streak,
   the adaptive schedule, resume at the experiment level with a
   ``metrics_dir`` (the CSV exactly-once, the JSONL appended, the manifest's
   ``resumed_from``), and the refusals of a mismatched trainer.
"""

import json

import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro_torch.channel import AdaptiveConfig, AdaptiveWeightSchedule
from repro_torch.ckpt import CheckpointWriter, read_state, restore_run_state
from repro_torch.fl.experiment import ExperimentSpec, build_experiment
from repro_torch.telemetry import JsonlSink


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- 1. the matrix ------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(conf.EXECUTION_MODES))
@pytest.mark.parametrize("strategy", conf.strategy_names())
def test_kill_resume_bitwise(strategy, mode, tmp_path):
    kw = conf.run_kwargs(mode)
    ref = conf.make_trainer(strategy, mode)
    ref.run(6, **kw)

    killed = conf.make_trainer(strategy, mode)
    killed.run(6, **kw, ckpt_dir=tmp_path, ckpt_every=3, ckpt_keep=0)
    assert CheckpointWriter(tmp_path).steps() == [3, 6]

    resumed = conf.make_trainer(strategy, mode)
    # resume semantics: `rounds` is the total target, not an increment
    resumed.run(6, **kw, resume_from=CheckpointWriter(tmp_path).path_for(3))
    assert resumed.round == 6
    conf.assert_same_run(ref, resumed)
    conf.assert_same_run(ref, killed)


def test_matrix_covers_the_registry():
    from repro_torch import strategies

    assert set(conf.strategy_names()) == set(strategies.available())
    assert set(conf.EXECUTION_MODES) == {"per_round", "chunked", "no_trace", "async"}


# -- 2. the protocol -----------------------------------------------------------------


def test_periodic_ckpt_dir_and_resume_latest(tmp_path):
    ref = conf.make_trainer()
    ref.run(9, chunk=3)
    a = conf.make_trainer()
    a.run(6, chunk=3, ckpt_dir=tmp_path, ckpt_every=3, ckpt_keep=2)
    assert CheckpointWriter(tmp_path).steps() == [3, 6]
    # the round-3 checkpoint was taken after round 3-5's batches were stacked
    assert [r["step"] for r in a.ckpt_records] == [3, 6]
    assert all(r["bytes"] > 0 and r["commit_s"] >= 0 for r in a.ckpt_records)
    b = conf.make_trainer()
    b.run(9, chunk=3, resume_from=tmp_path)  # a directory: its latest step
    conf.assert_same_run(ref, b)
    c = conf.make_trainer()
    c.run(9, chunk=3, resume_from=CheckpointWriter(tmp_path).path_for(3))
    conf.assert_same_run(ref, c)


def test_sparse_cadence_snapshots_only_saving_boundaries(tmp_path, monkeypatch):
    """With ``ckpt_every`` two chunks, the chunked loop records the clients'
    streams before its prefetch only at the boundary that saves (round 4);
    the final save follows the last chunk, which prefetches nothing, and
    reads the live streams.  The round-4 checkpoint resumes bitwise."""
    from repro_torch.fl import trainer as trainer_mod

    ref = conf.make_trainer()
    ref.run(8, chunk=2)
    calls = []
    encode = trainer_mod.rng_state_to_json
    monkeypatch.setattr(trainer_mod, "rng_state_to_json",
                        lambda rng: calls.append(1) or encode(rng))
    a = conf.make_trainer()
    a.run(8, chunk=2, ckpt_dir=tmp_path, ckpt_every=4, ckpt_keep=0)
    assert CheckpointWriter(tmp_path).steps() == [4, 8]
    assert len(calls) == 2 * conf.N  # the round-4 snapshot, the final save
    b = conf.make_trainer()
    b.run(8, chunk=2, resume_from=CheckpointWriter(tmp_path).path_for(4))
    conf.assert_same_run(ref, b)
    conf.assert_same_run(ref, a)


@pytest.mark.parametrize("run_kw, steps", [
    (dict(chunk=2, ckpt_every=2, ckpt_keep=2), [6, 8]),  # keep-last-2 retention
    (dict(chunk=1), [8]),  # ckpt_every=0: only the final save
])
def test_retention_and_final_only(tmp_path, run_kw, steps):
    conf.make_trainer().run(8, ckpt_dir=tmp_path, **run_kw)
    assert CheckpointWriter(tmp_path).steps() == steps
    assert read_state(CheckpointWriter(tmp_path).path_for(steps[-1]))["round"] == 8


def test_misaligned_cadence_is_an_error(tmp_path):
    with pytest.raises(ValueError, match="multiple of"):
        conf.make_trainer().run(6, chunk=3, ckpt_dir=tmp_path, ckpt_every=2)


@pytest.mark.parametrize("run_kw", [dict(chunk=3), dict(chunk=3, no_trace=True), dict(chunk=1)])
def test_telemetry_streak_resumes_bitwise(tmp_path, run_kw):
    ref = conf.make_trainer(telemetry=True)
    ref.run(6, **run_kw)
    t1 = conf.make_trainer(telemetry=True)
    t1.run(3, **run_kw)
    path = t1.save_checkpoint(tmp_path / "c.pt")
    t2 = conf.make_trainer(telemetry=True)
    t2.run(6, **run_kw, resume_from=path)
    conf.assert_same_run(ref, t2)
    assert ref.metrics.vector("outage_streak").shape == (6, conf.N)


def test_adaptive_schedule_resumes_bitwise(tmp_path):
    cfg = AdaptiveConfig(every=4, warmup=2, sweeps=3, fine_tune_sweeps=3)

    def mk():
        return conf.make_trainer(adaptive=AdaptiveWeightSchedule(conf.N, cfg))

    ref = mk()
    ref.run(8, chunk=2)
    assert ref.log.reopt_rounds, "the fixture must re-optimize"
    t1 = mk()
    t1.run(4, chunk=2)
    path = t1.save_checkpoint(tmp_path / "c.pt")
    t2 = mk()
    t2.run(8, chunk=2, resume_from=path)
    conf.assert_same_run(ref, t2)
    assert t2.log.reopt_rounds == ref.log.reopt_rounds and t2.log.S_est == ref.log.S_est
    assert t2.adaptive.events == ref.adaptive.events


def test_experiment_resume_with_metrics(tmp_path):
    def spec(**kw):
        return ExperimentSpec(model="quadratic", topology="fig2a", strategy="colrel",
                              channel="markov", chunk=3, rounds=6, seed=3, **kw)

    ref = build_experiment(spec(), device="cpu")
    ref.run(6)
    mdir, ck = tmp_path / "m", tmp_path / "ck"
    a = build_experiment(spec(metrics_dir=str(mdir), ckpt_dir=str(ck), ckpt_every=3),
                         device="cpu")
    a.run(3)
    a.close()
    b = build_experiment(spec(metrics_dir=str(mdir), ckpt_dir=str(ck), ckpt_every=3,
                              resume_from=str(ck)), device="cpu")
    b.run(6)
    b.close()
    assert b.trainer.telemetry  # a metrics_dir implies telemetry
    assert ref.log.loss == b.log.loss
    # the CSV is exactly-once across the resume
    rows = (mdir / "rounds.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [str(r) for r in range(6)]
    # the events are appended, seq increasing across the two runs
    events = JsonlSink.load(mdir / "events.jsonl")
    seqs = [e["seq"] for e in events if e["event"] == "round"]
    assert seqs == sorted(seqs) and len(seqs) == 6
    assert [e["event"] for e in events].count("summary.clients") == 2
    manifest = json.loads((mdir / "manifest.json").read_text())
    assert manifest["resumed_from"].endswith("ck") and manifest["backend"] == "cpu"
    vectors = np.load(mdir / "vectors.npz")
    assert vectors["outage_streak"].shape == (6, 10)
    assert vectors["outage_streak"].dtype == np.int32


def test_restore_refuses_mismatches(tmp_path):
    t1 = conf.make_trainer("colrel")
    t1.run(2)
    path = t1.save_checkpoint(tmp_path / "c.pt")

    with pytest.raises(ValueError, match="strategy"):
        conf.make_trainer("memory").run(6, resume_from=path)
    with pytest.raises(ValueError, match="telemetry"):
        conf.make_trainer("colrel", telemetry=True).run(6, resume_from=path)
    for key, value, match in (("version", 0, "version"), ("adaptive", {}, "adaptive")):
        state = read_state(path)
        state[key] = value
        with pytest.raises(ValueError, match=match):
            restore_run_state(conf.make_trainer("colrel"), state)
    state = read_state(path)
    state["clients"] = state["clients"][:-1]
    with pytest.raises(ValueError, match="client"):
        restore_run_state(conf.make_trainer("colrel"), state)
    for key, value, match in (("kind", "StaticChannel", "channel"), ("block", 8, "block")):
        state = read_state(path)
        state["channel"][key] = value
        with pytest.raises(ValueError, match=match):
            restore_run_state(conf.make_trainer("colrel"), state)
    with pytest.raises(ValueError, match="behind"):
        # the resumed total must not be behind the checkpointed round
        conf.make_trainer("colrel").run(1, resume_from=path)

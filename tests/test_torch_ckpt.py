"""The port's checkpoint subsystem on the CPU: the file format, the writer,
the generator encoding, the state hooks of every strategy, channel and
schedule, the logger's sinks across a resume, and the preemption guard.

1. ``checkpoint/io.py``: tensors (bf16 natively), numpy arrays of any dtype
   and plain values round-trip, tuples stay tuples, and an unsupported leaf
   (a raw ``torch.Generator``) is refused.
2. ``ckpt/writer.py``: the commit protocol (a checkpoint exists iff its
   sidecar does, so an orphan payload does not count), the refusal of a
   corrupted payload, keep-last-k retention, commit order, a writer error
   raised at the next ``wait``, and snapshot isolation: tensors and host
   arrays mutated in place after ``save`` leave the file as it was.
3. ``ckpt/keys.py`` and ``ckpt/schema.py``: a generator's state written back
   continues its stream, into an existing generator (its identity kept)
   or a new one; the numpy streams' JSON continues them; the clients' and
   the mobility channel's JSON strings equal the reference's after the
   same consumed rounds.
4. The hooks: every registered strategy's carried state (the codecs'
   generators by state), every channel kind mid-block and at a block edge
   (bitwise the uninterrupted stream), the mobility channel's current-epoch
   model, the estimator and the adaptive schedule (the same re-opts after
   the restore), the metrics logger (``seq``, TrainLog, ``round_metrics``,
   vectors), the JSONL sink's append and the CSV sink's trim, the
   manifest's ``resumed_from``, and ``PreemptionGuard`` on SIGTERM and
   SIGINT.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from repro.channel import MobilityChannel as JMobilityChannel
from repro.ckpt.schema import rng_state_to_json as j_rng_state_to_json
from repro.data.pipeline import ClientDataset as JClientDataset
from repro_torch import strategies, tree
from repro_torch.channel import (
    AdaptiveConfig,
    AdaptiveWeightSchedule,
    ClusteredMarkovChannel,
    ClusteredStaticChannel,
    LinkEstimator,
    MarkovChannel,
    MobilityChannel,
    StaticChannel,
    gilbert_elliott,
    gilbert_elliott_clustered,
)
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.ckpt import (
    AsyncCheckpointer,
    CheckpointWriter,
    PreemptionGuard,
    decode_generator,
    encode_generator,
    read_state,
    rng_from_json,
    rng_state_to_json,
    snapshot,
    write_state,
)
from repro_torch.core import topology
from repro_torch.data.pipeline import ClientDataset
from repro_torch.telemetry import CsvSummarySink, JsonlSink, MetricsLogger, RunManifest


def _same(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert tree.flatten(a)[1] == tree.flatten(b)[1]
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _state_tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4, dtype=torch.bfloat16)},
        "agg": (torch.zeros(4, 6), ()),
        "host": np.arange(5.0),
        "u16": np.arange(4, dtype=np.uint16),
        "scalar": np.float32(2.5),
        "round": 7,
        "rng": rng_state_to_json(np.random.default_rng(3)),
        "none": None,
        "list": [1, 2.5, "x"],
    }


# -- 1. the file format -----------------------------------------------------------


def test_io_roundtrip_keeps_dtypes_and_containers(tmp_path):
    tree_ = _state_tree()
    ckpt_io.save_checkpoint(tmp_path / "s.pt", tree_)
    back = ckpt_io.load_checkpoint(tmp_path / "s.pt")
    _same(back, tree_)
    assert isinstance(back["agg"], tuple) and isinstance(back["list"], list)
    assert back["scalar"].dtype == np.float32 and back["scalar"].shape == ()
    back["host"] += 1  # restored arrays are writable
    with pytest.raises(TypeError, match="cannot checkpoint"):
        ckpt_io.to_bytes({"gen": torch.Generator()})


# -- 2. the writer ----------------------------------------------------------------------


def test_write_read_corruption_and_orphans(tmp_path):
    w = CheckpointWriter(tmp_path, keep=0)
    n_bytes = w.save(1, _state_tree())
    assert n_bytes == w.path_for(1).stat().st_size
    _same(read_state(w.path_for(1)), _state_tree())
    # a payload without its sidecar (a crash between the renames) is no step
    w.path_for(2).write_bytes(w.path_for(1).read_bytes())
    assert w.steps() == [1] and w.latest_step() == 1
    # a corrupted payload is refused
    data = bytearray(w.path_for(1).read_bytes())
    data[len(data) // 2] ^= 0xFF
    w.path_for(1).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        w.load(1)
    with pytest.raises(FileNotFoundError):
        CheckpointWriter(tmp_path / "empty").load()


def test_async_retention_order_and_errors(tmp_path):
    ck = AsyncCheckpointer(tmp_path / "ck", keep=3)
    for step in (2, 4, 6, 8):
        ck.save(step, {"x": torch.full((3,), float(step))})
    ck.close()  # drains the queue before stopping
    w = CheckpointWriter(tmp_path / "ck")
    assert w.steps() == [4, 6, 8]
    assert torch.equal(w.load(8)["x"], torch.full((3,), 8.0))
    assert [r["step"] for r in ck.records] == [2, 4, 6, 8]
    assert all(r["bytes"] > 0 and r["commit_s"] >= 0 for r in ck.records)
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(10, {})
    bad = AsyncCheckpointer(tmp_path / "bad", keep=0)
    bad.save(1, {"bad": object()})  # not serializable: fails in the writer
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        bad.wait()
    bad.close()


def test_snapshot_isolation(tmp_path):
    """The trainer's carry is written in place after a save (the chunked
    engine's static buffers, the memory kernels' buffer): the snapshot owns
    copies, so the file holds the state at ``save``."""
    t = torch.arange(4.0)
    host = np.arange(4.0)
    snap = snapshot({"t": t, "host": host})
    t.add_(100.0)
    host += 100.0
    write_state(tmp_path / "s.pt", snap)
    back = read_state(tmp_path / "s.pt")
    assert torch.equal(back["t"], torch.arange(4.0))
    np.testing.assert_array_equal(back["host"], np.arange(4.0))


def test_snapshot_isolation_from_the_trainers_carry(tmp_path):
    import _torch_conformance as conf
    from repro_torch.ckpt import capture_run_state

    tr = conf.make_trainer("memory", "chunked")
    tr.run(3, chunk=3)
    want = tr.agg_state.clone()
    snap = snapshot(capture_run_state(tr))
    tr.params["x"].add_(1.0)
    tr.agg_state.add_(1.0)
    tr.run(3, chunk=3)  # the next chunk overwrites the carry in place
    write_state(tmp_path / "s.pt", snap)
    assert torch.equal(read_state(tmp_path / "s.pt")["agg_state"], want)


# -- 3. generators and numpy streams ---------------------------------------------------


def test_generator_roundtrip_continues_the_stream(tmp_path):
    g = torch.Generator().manual_seed(5)
    torch.rand(7, generator=g)
    path = tmp_path / "g.pt"
    ckpt_io.save_checkpoint(path, {"g": encode_generator(g)})
    saved = ckpt_io.load_checkpoint(path)["g"]
    want = torch.rand(16, generator=g)
    fresh = decode_generator(saved)
    assert torch.equal(torch.rand(16, generator=fresh), want)
    other = torch.Generator().manual_seed(99)
    into = decode_generator(saved, into=other)
    assert into is other and torch.equal(torch.rand(16, generator=other), want)
    assert encode_generator(3) == 3


def test_rng_json_roundtrip_and_refusal():
    rng = np.random.default_rng(11)
    rng.normal(size=100)
    back = rng_from_json(rng_state_to_json(rng))
    np.testing.assert_array_equal(back.normal(size=32), rng.normal(size=32))
    with pytest.raises(ValueError, match="MT19937"):
        rng_from_json(json.dumps({"bit_generator": "MT19937", "state": {}}))


def test_client_and_mobility_streams_equal_the_reference():
    data = {"x": np.arange(200, dtype=np.float32).reshape(50, 4)}
    ours, theirs = ClientDataset(data, batch_size=4, seed=7), JClientDataset(data, batch_size=4,
                                                                            seed=7)
    for m in (3, 5):
        ours.next_batches(m)
        theirs.next_batches(m)
    assert rng_state_to_json(ours._rng) == j_rng_state_to_json(theirs._rng)
    mob, jmob = MobilityChannel(6, epoch=3, seed=5), JMobilityChannel(6, epoch=3, seed=5)
    for r in range(7):
        mob.tau_for_round(r)
        jmob.tau_for_round(r)
    state, jstate = mob.checkpoint_state(), jmob.checkpoint_state()
    assert state["rng"] == jstate["rng"] == j_rng_state_to_json(jmob._rng)
    assert state["next"] == jstate["next"] and state["models"].keys() == jstate["models"].keys()
    np.testing.assert_array_equal(state["positions"], jstate["positions"])
    np.testing.assert_array_equal(state["waypoints"], jstate["waypoints"])


# -- 4. the hooks -------------------------------------------------------------------------


def test_strategy_registry_fully_covered():
    assert set(strategies.available()) == {
        "async_colrel", "clustered", "colrel", "fedavg_blind", "fedavg_nonblind",
        "fedavg_perfect", "memory", "multihop", "quantized"}


_STATES = [("async_colrel", {}), ("clustered", {}), ("colrel", {}), ("fedavg_blind", {}),
           ("fedavg_nonblind", {}), ("fedavg_perfect", {}), ("memory", {}),
           ("multihop", {}), ("quantized", {"codec": "int8", "inner": "memory"}),
           ("quantized", {"codec": "randk"})]


@pytest.mark.parametrize("name, options", _STATES,
                         ids=[f"{n}-{o.get('codec', '')}" for n, o in _STATES])
def test_strategy_agg_state_roundtrip(name, options, tmp_path):
    s = strategies.get(name, **options)
    state = s.init_state(6, 24)
    # carried tensors off their init values, generators advanced
    state = tree.map(lambda x: x if isinstance(x, torch.Generator) else x + 3, state)
    for g in tree.leaves(state):
        if isinstance(g, torch.Generator):
            torch.rand(5, generator=g)
    write_state(tmp_path / "a.pt", {"agg": s.checkpoint_state(state)})
    saved = read_state(tmp_path / "a.pt")["agg"]
    _same(s.restore_state(saved), state)
    # into the trainer's existing state: the same generator objects
    like = s.init_state(6, 24)
    back = s.restore_state(saved, like=like)
    _same(back, state)
    for got, old in zip(tree.leaves(back), tree.leaves(like)):
        if isinstance(old, torch.Generator):
            assert got is old


def _channel_factories():
    model = topology.fully_connected(6, 0.4, p_c=0.7, rho=0.6)
    cmodel = topology.clustered_blocks(6, 0.4, 3, p_intra=0.7, rho=0.6)
    return {
        "static": lambda: StaticChannel(model, seed=5, block=4),
        "markov": lambda: MarkovChannel(gilbert_elliott(model, memory=0.8), seed=5, block=4),
        "clustered_static": lambda: ClusteredStaticChannel(cmodel, seed=5, block=4),
        "clustered_markov": lambda: ClusteredMarkovChannel(
            gilbert_elliott_clustered(cmodel, memory=0.8), seed=5, block=4),
        "mobility": lambda: MobilityChannel(6, epoch=3, seed=5),
    }


@pytest.mark.parametrize("kind", sorted(_channel_factories()))
@pytest.mark.parametrize("consumed", [0, 5, 8], ids=["fresh", "mid-block", "block-edge"])
def test_channel_state_roundtrip_bitwise(kind, consumed, tmp_path):
    mk = _channel_factories()[kind]
    ref = mk()
    ref_stream = [ref.tau_for_round(r) for r in range(14)]
    a = mk()
    for r in range(consumed):
        a.tau_for_round(r)
    write_state(tmp_path / "c.pt", a.checkpoint_state())
    b = mk()
    b.restore_state(read_state(tmp_path / "c.pt"))
    for r in range(consumed, 14):
        tu, td = b.tau_for_round(r)
        np.testing.assert_array_equal(tu, ref_stream[r][0], err_msg=f"r={r}")
        np.testing.assert_array_equal(td, ref_stream[r][1], err_msg=f"r={r}")


def test_channel_restore_refuses_mismatches():
    model = topology.fully_connected(6, 0.4, p_c=0.7, rho=0.6)
    a = StaticChannel(model, seed=5, block=4)
    a.tau_for_round(0)
    state = a.checkpoint_state()
    with pytest.raises(ValueError, match="block size"):
        StaticChannel(model, seed=5, block=8).restore_state(state)
    with pytest.raises(ValueError, match="StaticChannel"):
        MarkovChannel(gilbert_elliott(model, memory=0.8), seed=5, block=4).restore_state(state)
    with pytest.raises(ValueError, match="StaticChannel"):
        MobilityChannel(6, seed=5).restore_state(state)


def test_mobility_checkpoint_carries_current_epoch_model(tmp_path):
    a = MobilityChannel(6, epoch=4, seed=9)
    for r in range(6):  # into epoch 1
        a.tau_for_round(r)
    write_state(tmp_path / "m.pt", a.checkpoint_state())
    b = MobilityChannel(6, epoch=4, seed=9)
    b.restore_state(read_state(tmp_path / "m.pt"))
    np.testing.assert_array_equal(b.model_for_round(5).p, a.model_for_round(5).p)
    np.testing.assert_array_equal(b.model_for_round(5).P, a.model_for_round(5).P)
    with pytest.raises(ValueError, match="epoch 0"):
        b.model_for_round(0)  # stale epochs are not shipped


def test_estimator_and_schedule_roundtrip(tmp_path):
    def feed(sched, r0, rounds, rng):
        out = []
        for r in range(r0, r0 + rounds):
            A = sched.step(r, rng.integers(0, 2, 4).astype(float),
                           rng.integers(0, 2, (4, 4)).astype(float))
            out.append(None if A is None else np.asarray(A))
        return out

    cfg = AdaptiveConfig(every=6, warmup=4, sweeps=3, fine_tune_sweeps=3, decay=0.99)
    ref_out = feed(AdaptiveWeightSchedule(4, cfg), 0, 18, np.random.default_rng(2))
    rng = np.random.default_rng(2)
    a = AdaptiveWeightSchedule(4, cfg)
    feed(a, 0, 9, rng)
    write_state(tmp_path / "s.pt", a.checkpoint_state())
    b = AdaptiveWeightSchedule(4, cfg)
    b.restore_state(read_state(tmp_path / "s.pt"))
    assert b.events == a.events and b.estimator.rounds == a.estimator.rounds
    np.testing.assert_array_equal(b.estimator.E_hat, a.estimator.E_hat)
    out = feed(b, 9, 9, rng)
    assert [o is None for o in out] == [o is None for o in ref_out[9:]]
    for got, want in zip(out, ref_out[9:]):
        if got is not None:
            np.testing.assert_array_equal(got, want)
    est = LinkEstimator(4)
    est.restore_state(a.estimator.checkpoint_state())
    np.testing.assert_array_equal(est.p_hat, a.estimator.p_hat)


def test_metrics_logger_roundtrip_continues_seq_and_vectors(tmp_path):
    a = MetricsLogger()
    a.log_rounds(0, {"loss": torch.arange(3.0), "participation": torch.ones(3),
                     "delta_norm": torch.zeros(3),
                     "client_participation": torch.ones(3, 4),
                     "outage_streak": torch.zeros(3, 4, dtype=torch.int32)}, k=3)
    a.log_eval(2, {"acc": 0.5})
    write_state(tmp_path / "m.pt", a.checkpoint_state())
    b = MetricsLogger()
    b.restore_state(read_state(tmp_path / "m.pt"))
    assert b._seq == a._seq and b.log == a.log and b.round_metrics == a.round_metrics
    np.testing.assert_array_equal(b.vector("client_participation"),
                                  a.vector("client_participation"))
    assert b.vector("outage_streak").dtype == np.int32
    b.log_rounds(3, {"loss": torch.zeros(())})
    assert b.log.rounds == [0, 1, 2, 3] and b.round_metrics["loss"] == [0.0, 1.0, 2.0, 0.0]


def test_jsonl_append_and_csv_trim_on_resume(tmp_path):
    path = tmp_path / "events.jsonl"
    s1 = JsonlSink(path)
    s1.emit({"event": "round", "seq": 0, "round": 0})
    s1.close()
    s2 = JsonlSink(path, resume=True)
    s2.emit({"event": "round", "seq": 1, "round": 1})
    s2.close()
    assert [e["seq"] for e in JsonlSink.load(path)] == [0, 1]
    JsonlSink(path)  # without resume: one run a file
    assert JsonlSink.load(path) == []

    csv = tmp_path / "rounds.csv"
    c1 = CsvSummarySink(csv)
    for r in range(5):
        c1.emit({"event": "round", "round": r, "loss": float(r)})
    c1.close()
    c2 = CsvSummarySink(csv, resume=True)
    c2.trim_rounds_after(2)  # resumed from a round-3 checkpoint
    c2.emit({"event": "round", "round": 3, "loss": 30.0})
    c2.close()
    rows = csv.read_text().splitlines()
    assert [row.split(",")[0] for row in rows[1:]] == ["0", "1", "2", "3"]
    assert rows[4].split(",")[1] == "30.0"


def test_manifest_records_resumed_from(tmp_path):
    m = RunManifest.collect({"rounds": 8}, device="cpu", strategy="colrel",
                            resumed_from="/ck/ckpt_00000004.pt")
    assert m.resumed_from == "/ck/ckpt_00000004.pt"
    assert RunManifest.collect({"rounds": 8}, device="cpu").resumed_from is None
    p = m.write(tmp_path)
    assert json.loads(p.read_text())["resumed_from"].endswith("4.pt")


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_preemption_guard_latches_and_restores(signum):
    before = signal.getsignal(signum)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signum)
        assert guard.triggered and guard.signum == signum
    assert signal.getsignal(signum) is before

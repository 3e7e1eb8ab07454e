"""The port's launch layer against live reference runs, on the CPU: the
input specs, the zoo's gradients, the ``train`` step kind, and the
training CLI (``python -m repro_torch.launch.train``).

1. ``input_specs``: the meta-tensor stand-ins have the reference's
   ``ShapeDtypeStruct`` shapes and dtypes: ``params_spec`` of every arch at
   ``full()``, ``_train_batch_spec`` in every mode at n_clients 1 and 8,
   and whole ``input_specs`` of the three kinds for one arch a family (the
   reference's given a stand-in mesh of n_clients data rows).
2. The zoo's gradients: the ten arch ids at ``smoke()`` (f32), the port fed
   the reference's params and the same numpy batch, ``torch.autograd``
   against ``jax.grad`` of the reference ``loss_fn``, the loss at rtol
   1e-5 and each leaf within ``GRAD_TOL`` times the reference's largest
   gradient of that leaf.  The zoo's init makes the softmaxes nearly
   one-hot, so f32 rounding is amplified in the backward: against the f64
   gradient of the same params, the reference's own f32 gradients err by
   up to 3.9e-3 of the leaf's scale (seamless; 7.8e-5 on dbrx, 9e-7 on
   qwen3) and the port's by up to 3.4e-4 (seamless; 3.1e-4 on deepseek),
   in f32 islands (softmax, cross-entropy) both keep in f64 runs too; the
   two errors add.
3. ``build_step(bundle, "train")`` against the reference round built from
   ``repro.fl.round`` with the same optimizers and hyperparameters: every
   arch in its smoke config's mode (``per_client``) and qwen3 in the three
   other modes, one round on the same params, batches and taus, n = 2
   clients: the round's mean loss at rtol ``ROUND_LOSS_RTOL`` (its second
   local step runs from params that carry the first step's gradient
   error of 2.), participation and uplink_bits
   equal, each leaf of the params within ``max(1e-6, n * GRAD_TOL *
   max|update|)`` of the reference's (the update, the leaf's change in the
   round, sums the n clients' gradients, each held as in 2.).  seamless
   takes one local step, not ``DRYRUN_LOCAL_STEPS``: at its smoke config a
   second step is chaotic in the reference itself (params scaled by 1 +
   1e-7 move the encoder's and the cross-attention's leaves after one
   round by 50-100% of their update), so past one step the two packages'
   f32 roundings decorrelate.
4. The CLI at ``--smoke --device cpu``, started from the reference's init
   (``train(..., params=converted)``), against a loop of the same
   ``repro`` pieces the reference launcher assembles (the channel,
   COPT-alpha, the batch stream from ``--seed``, ``make_round_fn`` with
   ``sgd(0.25)`` and ``sgd_momentum(1.0, 0.9)``): per-round loss and
   delta_norm at rtol 1e-5, participation equal; per round, ``--fused-kernel
   --segment-d``, ``--async-mode`` and ``--metrics-dir``; ``--chunk 2``
   bitwise its per-round run.  The flag validation of
   ``tests/test_resume.py`` mirrored; without ``--device`` and without
   CUDA the CLI raises; a SIGTERM after chunk 2 and ``--resume`` give a
   byte-equal ``rounds.csv`` (``tools/torch_kill_resume_smoke.py``), and
   so does a ``--no-trace`` run resumed mid-way.
5. The same step's gradients repeat bitwise on four CPU threads.
"""

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.configs import base as jbase
from repro.configs.channels import make_channel as jmake_channel
from repro.core import optimize_weights as joptimize_weights
from repro.core import topology as jtopology
from repro.fl.round import RoundConfig as JRoundConfig
from repro.fl.round import make_async_round_fn as jmake_async_round_fn
from repro.fl.round import make_round_fn as jmake_round_fn
from repro.launch import specs as jspecs
from repro.models import build as jbuild
from repro.optim import sgd as jsgd
from repro.optim import sgd_momentum as jsgd_momentum
from repro_torch import tree
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.launch import specs, steps
from repro_torch.launch import train as train_mod
from repro_torch.models import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = sorted(base.CLI_ALIASES)
GRAD_TOL = 5e-3
LOSS_RTOL = 1e-5
ROUND_LOSS_RTOL = 1e-4
MODES = ("per_client", "client_sequential", "weighted_grad", "weighted_flat")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jpath(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _same_specs(got, want):
    """A tree of meta tensors against one of ShapeDtypeStructs: the same
    paths, shapes and dtypes."""
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert tree.paths(got) == [_jpath(p) for p, _ in jl]
    for g, (_, w) in zip(tree.leaves(got), jl):
        assert g.is_meta, g.device
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


# -- 1. input specs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_spec_matches_reference(arch):
    got = specs.params_spec(build(base.get_arch(arch).full()))
    _same_specs(got, jspecs.params_spec(jbuild(jbase.get_arch(arch).full())))


@pytest.mark.parametrize("n_clients", [1, 8])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-2b", "seamless-m4t-large-v2"])
def test_train_batch_spec_matches_reference(arch, mode, n_clients):
    shape = base.INPUT_SHAPES["train_4k"]
    got = specs._train_batch_spec(base.get_arch(arch).full(), n_clients, shape, mode)
    want = jspecs._train_batch_spec(jbase.get_arch(arch).full(), n_clients,
                                    jbase.INPUT_SHAPES["train_4k"], mode)
    _same_specs(got, want)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b", "rwkv6-1.6b"])
def test_input_specs_match_reference(arch, shape_name):
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 8, "model": 1})
    want = jspecs.input_specs(arch, shape_name, mesh)
    got = specs.input_specs(arch, shape_name, 8)
    assert got["kind"] == want["kind"] == jbase.INPUT_SHAPES[shape_name].kind
    assert sorted(got) == sorted(want)
    for key in got:
        if key not in ("kind", "cfg"):
            _same_specs(got[key], want[key])
    assert specs.DRYRUN_LOCAL_STEPS == jspecs.DRYRUN_LOCAL_STEPS


# -- 2. the zoo's gradients ------------------------------------------------------------


def _lm_batch(cfg, rng, lead, S):
    toks = rng.integers(0, cfg.vocab_size, size=(*lead, S + 1), dtype=np.int32)
    # copies: masking a label must not write into the tokens it overlaps
    batch = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    if cfg.frontend_tokens:
        batch["prefix"] = rng.normal(size=(*lead, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_gradients_match_reference(arch):
    jcfg, cfg = jbase.get_arch(arch).smoke(), base.get_arch(arch).smoke()
    jb, b = jbuild(jcfg), build(cfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    batch = _lm_batch(cfg, np.random.default_rng(3), (2,), 16)
    batch["labels"][0, :3] = -1  # masked positions
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jb.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(jparams)
    params = tree.map(lambda x: x.requires_grad_(),
                      params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))
    loss, _ = b.loss_fn(params, _to_torch(batch))
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert tree.paths(params) == [_jpath(p) for p, _ in jl]
    for path, g, (_, w) in zip(tree.paths(params), grads, jl):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max()) if w.size else 0.0
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-6), (path, err)


# -- 3. the train step kind --------------------------------------------------------------


def _round_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    m = jtopology.fully_connected(n, 0.6, p_c=0.8)
    tu = (rng.random(n) < 0.6).astype(np.float32)
    td = (rng.random((n, n)) < 0.8).astype(np.float32)
    np.fill_diagonal(td, 1.0)
    A = np.asarray(joptimize_weights(m, sweeps=5).A, np.float32)
    return rng, tu, td, A


@pytest.mark.parametrize("arch,mode", [(a, "per_client") for a in ARCHS]
                         + [("qwen3-0.6b", m) for m in MODES[1:]])
def test_train_step_tracks_reference_round(arch, mode):
    jcfg, cfg = jbase.get_arch(arch).smoke(), base.get_arch(arch).smoke()
    assert cfg.fl_mode == "per_client"
    jb, b = jbuild(jcfg), build(cfg)
    n, B, S = 2, 2, 8
    T = 1 if arch == "seamless-m4t-large-v2" else specs.DRYRUN_LOCAL_STEPS
    rng, tu, td, A = _round_inputs(n)
    lead = {"weighted_flat": (n * B,), "weighted_grad": (n, B)}.get(mode, (n, T, B))
    batches = _lm_batch(cfg, rng, lead, S)
    jparams = jb.init(jax.random.PRNGKey(0))
    jserver = jsgd_momentum(1.0, beta=steps.SERVER_MOMENTUM)
    jrc = JRoundConfig(n_clients=n, local_steps=T, mode=mode, aggregation="colrel")
    jfn = jax.jit(jmake_round_fn(jb.loss_fn, jsgd(steps.CLIENT_LR, weight_decay=steps.CLIENT_WD),
                                 jserver, jrc))
    jp, _, _, jm = jfn(jparams, jserver.init(jparams), (),
                       {k: jnp.asarray(v) for k, v in batches.items()}, jnp.asarray(tu),
                       jnp.asarray(td), jnp.asarray(A))

    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    fn = steps.build_step(b, "train", n_clients=n, fl_mode=mode)
    server = steps.sgd_momentum(1.0, beta=steps.SERVER_MOMENTUM)
    p, _, _, m = fn(params, server.init(params), (), _to_torch(batches), torch.from_numpy(tu),
                    torch.from_numpy(td), torch.from_numpy(A))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=ROUND_LOSS_RTOL)
    for key in ("participation", "uplink_bits"):
        assert float(m[key]) == float(jm[key]), key
    np.testing.assert_allclose(float(m["weight_sum"]), float(jm["weight_sum"]), atol=1e-6)
    for path, got, want, p0 in zip(tree.paths(p), tree.leaves(p), jax.tree.leaves(jp),
                                   tree.leaves(params)):
        want = np.asarray(want)
        upd = float(np.abs(want - p0.numpy()).max()) if want.size else 0.0
        err = float(np.abs(got.numpy() - want).max()) if want.size else 0.0
        assert err <= max(1e-6, n * GRAD_TOL * upd), (path, err, upd)


def test_train_step_scan_and_async_kinds():
    b = build(base.get_arch("qwen3-0.6b").smoke())
    scan = steps.build_step(b, "train", n_clients=2, scan_rounds=2)
    assert type(scan).__name__ == "ScanRound"
    fn = steps.build_step(b, "train", n_clients=2, aggregation="async_colrel", telemetry=True)
    assert "stale_frac" in fn.metric_keys and "mean_age" in fn.metric_keys


# -- 4. the CLI --------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--n-clients", "4", "--local-steps", "2", "--batch",
         "2", "--seq-len", "16"]


def _jparams():
    return jbuild(jbase.get_arch("qwen3-0.6b").smoke()).init(jax.random.PRNGKey(0))


def _reference_launch(rounds, *, fused_kernel=False, segment_d=0, async_mode=False, seed=0,
                      n=4, T=2, B=2, S=16, channel="static"):
    """The reference launcher's per-round loop, from its own pieces."""
    cfg = jbase.get_arch("qwen3-0.6b").smoke()
    bundle = jbuild(cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    strategy = jstrategies.get("colrel", fused="kernel" if fused_kernel else "collapse")
    if async_mode:
        strategy = jstrategies.AsyncRelayStrategy(inner=strategy, gamma=0.9)
    link_model = jtopology.fully_connected(n, 0.3, p_c=0.8, rho=1.0)
    ch = jmake_channel(channel, link_model, n=n, seed=seed)
    A = jnp.asarray(joptimize_weights(link_model, sweeps=20, fine_tune_sweeps=20).A, jnp.float32)
    rc = JRoundConfig(n_clients=n, local_steps=T, mode="per_client", aggregation=strategy,
                      segment_d=segment_d)
    server = jsgd_momentum(1.0, beta=0.9)
    mk = jmake_async_round_fn if async_mode else jmake_round_fn
    fn = jax.jit(mk(bundle.loss_fn, jsgd(0.25), server, rc))
    from repro.core.flatten import flat_spec
    sstate, agg = server.init(params), strategy.init_state(n, flat_spec(params).d)
    rng = np.random.default_rng(seed)
    out = {"loss": [], "participation": [], "delta_norm": []}
    for r in range(rounds):
        tu, td = ch.tau_for_round(r)
        toks = rng.integers(0, cfg.vocab_size, size=(n, T, B, S + 1), dtype=np.int32)
        batches = {"tokens": jnp.asarray(toks[..., :-1]), "labels": jnp.asarray(toks[..., 1:])}
        params, sstate, agg, m = fn(params, sstate, agg, batches, jnp.asarray(tu, jnp.float32),
                                    jnp.asarray(td, jnp.float32), A)
        for k in out:
            out[k].append(float(m[k]))
    return out


def _tracks(result, want):
    np.testing.assert_allclose(result.metrics["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(result.metrics["delta_norm"], want["delta_norm"],
                               rtol=LOSS_RTOL, atol=1e-7)
    assert result.metrics["participation"] == want["participation"]


@pytest.mark.parametrize("case", ["collapse", "segmented_kernel", "async", "metrics_dir"])
def test_cli_tracks_reference_launch(case, tmp_path, capsys):
    rounds = 3
    flags = {"collapse": [], "segmented_kernel": ["--fused-kernel", "--segment-d", "1"],
             "async": ["--async-mode"],
             "metrics_dir": ["--metrics-dir", str(tmp_path / "m")]}[case]
    init = params_from_jax(jax.tree.map(np.asarray, _jparams()), "cpu")
    res = train_mod.train([*SMOKE, "--rounds", str(rounds), *flags], params=init)
    assert res.rounds == rounds and len(res.metrics["loss"]) == rounds
    want = _reference_launch(rounds, fused_kernel=case == "segmented_kernel",
                             segment_d=1 if case == "segmented_kernel" else 0,
                             async_mode=case == "async")
    _tracks(res, want)
    out = capsys.readouterr().out
    assert out.count("round ") == rounds and "participants=" in out
    if case == "async":
        assert "stale_frac" in res.metrics and "stale=" in out
    if case == "metrics_dir":
        rows = (tmp_path / "m" / "rounds.csv").read_text().splitlines()
        assert len(rows) == rounds + 1 and rows[0].startswith("round,loss")
        assert [float(r.split(",")[1]) for r in rows[1:]] == res.metrics["loss"]
        assert {p.name for p in (tmp_path / "m").iterdir()} >= {
            "events.jsonl", "rounds.csv", "manifest.json", "vectors.npz"}


@pytest.mark.parametrize("flags", [["--fused-kernel"], ["--channel", "markov", "--no-trace"]])
def test_cli_chunk_is_bitwise_its_per_round_run(flags):
    init = params_from_jax(jax.tree.map(np.asarray, _jparams()), "cpu")
    no_trace = "--no-trace" in flags
    base_flags = [*SMOKE, "--rounds", "4", *flags]
    chunked = train_mod.train([*base_flags, "--chunk", "2"], params=init)
    if no_trace:  # no per-round twin: the sampler's law, held in tests/test_torch_scan.py
        assert chunked.rounds == 4 and all(np.isfinite(chunked.metrics["loss"]))
        return
    per_round = train_mod.train(base_flags, params=init)
    assert chunked.metrics == per_round.metrics
    for a, b in zip(tree.leaves((chunked.params, chunked.server_state)),
                    tree.leaves((per_round.params, per_round.server_state))):
        assert torch.equal(a, b)
    assert chunked.scan_stats.get("replays") is None  # the CPU runs the body, no graph


def test_cli_flag_validation(capsys):
    """``tests/test_resume.py::test_launcher_flag_validation``, mirrored."""

    def refused(*flags):
        with pytest.raises(SystemExit) as e:
            train_mod.main([*SMOKE, "--rounds", "8", *flags])
        assert e.value.code == 2
        return capsys.readouterr().err

    assert "multiple of --chunk" in refused("--chunk", "4", "--ckpt-dir", "/tmp/x",
                                            "--ckpt-every", "6")
    assert "--ckpt-dir" in refused("--resume")
    assert "--ckpt-dir" in refused("--ckpt-every", "2")
    assert "--fused-kernel requires --aggregation colrel" in refused(
        "--fused-kernel", "--aggregation", "memory")
    assert "divide --rounds" in refused("--chunk", "3")
    assert "--no-trace" in refused("--no-trace")
    assert "already asynchronous" in refused("--aggregation", "async_colrel", "--async-mode")
    assert "scan_sampler" in refused("--channel", "mobility", "--chunk", "2", "--no-trace")


def test_cli_needs_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--smoke", "--rounds", "1"])


def test_cli_kill_and_resume_is_bitwise(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "torch_kill_resume_smoke", ROOT / "tools" / "torch_kill_resume_smoke.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert tool.run("cpu", rounds=8, chunk=2, workdir=tmp_path) == 8
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.sha256"))[-1] == \
        "ckpt_00000008.pt.sha256"


def test_zoo_gradients_repeat_bitwise_on_cpu_threads():
    """The same step's gradients, ten times on four CPU threads: bitwise
    equal.  The token lookup's backward sums repeated tokens' gradients;
    indexing (``embed[tokens]``) summed them in a varying order there, so
    two runs of the same training (and a kill/resume) differed in the last
    bit; ``F.embedding`` sums in a fixed order."""
    cfg = base.get_arch("qwen3-0.6b").smoke()
    b = build(cfg)
    params = b.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads():
        p = tree.map(lambda x: x.detach().requires_grad_(), params)
        loss, _ = b.loss_fn(p, batch)
        return torch.autograd.grad(loss, tree.leaves(p))

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        want = grads()
        for _ in range(10):
            assert all(torch.equal(g, w) for g, w in zip(grads(), want))
    finally:
        torch.set_num_threads(threads)


def test_cli_resume_with_no_trace_is_bitwise(tmp_path):
    """``--no-trace``: the in-scan sampler's state and generator ride the
    checkpoint's ``no_trace`` entry, so 4 rounds, then ``--resume`` to 6,
    equal 6 uninterrupted rounds: every metric, the params and rounds.csv."""
    flags = [*SMOKE, "--local-steps", "1", "--channel", "markov", "--no-trace", "--chunk", "2"]
    full = train_mod.train([*flags, "--rounds", "6", "--metrics-dir", str(tmp_path / "ref")])
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2", "--metrics-dir",
          str(tmp_path / "m")]
    train_mod.train([*flags, "--rounds", "4", *ck])
    resumed = train_mod.train([*flags, "--rounds", "6", "--resume", *ck])
    assert resumed.rounds == 6 and resumed.metrics == full.metrics
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(resumed.params),
                                                 tree.leaves(full.params)))
    assert (tmp_path / "m" / "rounds.csv").read_bytes() == \
        (tmp_path / "ref" / "rounds.csv").read_bytes()

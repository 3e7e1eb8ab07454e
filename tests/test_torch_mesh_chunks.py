"""The chunked engine on a mesh, the counterpart of the reference's
``tests/test_scan_engine.py::test_build_scan_step_lowers`` and
``tests/test_telemetry.py::test_build_step_telemetry_lowers[scan]``.

* ``build_step(arch, shape, mesh, scan_rounds=2)`` on the duck-typed 16x16,
  2x16x16 and (4, 2) meshes: its in- and out-shardings equal the
  reference's spec for spec, its args carry the K axis, with telemetry and
  without.
* One gloo job of 4 ranks on a ``(2, 2)`` ``("data", "model")`` mesh runs
  qwen3-0.6b at ``smoke()`` (n = 4 clients, T = 2, B = 2, S = 32) through
  the steps ``build_step`` builds on the mesh, four forms: ``per_client``
  colrel, ``weighted_grad``, ``per_client`` with telemetry and
  ``async_colrel``.  On every rank a K = 2 chunk is bitwise two per-round
  mesh rounds (carry, metrics, telemetry vectors).  The test holds the
  mesh's chunk against the port's unsharded chunk and the reference's,
  made while the job runs, at ``atol=3e-5, rtol=3e-4`` (loss within 1e-4).

Each rank runs one CPU thread; the job is a subprocess with its own timeout.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.configs.base import get_arch as jget_arch
from repro.fl.round import (RoundConfig as JRoundConfig,
                            make_async_scan_round_fn as jmake_async_scan_round_fn,
                            make_scan_round_fn as jmake_scan_round_fn)
from repro.launch import steps as jsteps
from repro.models import build as jbuild
from repro.optim import sgd as jsgd, sgd_momentum as jsgd_momentum
from repro.telemetry.device import init_streak as jinit_streak
from repro_torch import tree
from repro_torch.launch import steps

from test_torch_sharding import _meshes, _same

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
N, T, B, S, K = 4, 2, 2, 32, 2
FORMS = ("per_client", "weighted_grad", "telemetry", "async_colrel")

CHUNK_JOB = textwrap.dedent('''
    import os, sys, tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, init, data, dest):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        from repro_torch import strategies, tree
        from repro_torch.configs.base import InputShape, get_arch
        from repro_torch.convert import params_from_jax
        from repro_torch.core import flatten
        from repro_torch.dist import make_debug_mesh
        from repro_torch.launch.steps import SERVER_MOMENTUM, build_step, place
        from repro_torch.optim import sgd_momentum
        from repro_torch.telemetry.device import init_streak

        z = np.load(data)
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        cfg = get_arch("qwen3-0.6b").smoke()
        shape = InputShape("t", 32, 8, "train")
        names = [k[2:] for k in z.files if k.startswith("p:")]
        params = tree.from_paths({k: params_from_jax(z["p:" + k], "cpu") for k in names})
        server = sgd_momentum(1.0, beta=SERVER_MOMENTUM)
        d = flatten.flat_spec(params).d
        results = {}

        def whole(x):
            return x.full_tensor() if hasattr(x, "full_tensor") else x

        for form in ("per_client", "weighted_grad", "telemetry", "async_colrel"):
            mode = "weighted_grad" if form == "weighted_grad" else "per_client"
            agg = "async_colrel" if form == "async_colrel" else "colrel"
            tel = form == "telemetry"
            tok = torch.from_numpy(z["tokens"]).long()
            lab = torch.from_numpy(z["labels"]).long()
            if mode == "weighted_grad":  # the T = 1 collapse: (K, n, B, S)
                tok, lab = tok[:, :, 0], lab[:, :, 0]
            xs = {"tokens": tok, "labels": lab}
            tu, td = torch.from_numpy(z["tau_up"]), torch.from_numpy(z["tau_dd"])
            A = torch.from_numpy(z["A"])
            agg0 = strategies.resolve(agg).init_state(4, d)
            extra = (init_streak(4),) if tel else ()

            def build(mesh_, k):
                return build_step("qwen3-0.6b", shape, mesh_, n_clients=4, aggregation=agg,
                                  fl_mode=mode, cfg_override=cfg, scan_rounds=k, telemetry=tel)

            def carry(sh):
                return (place(params, sh[0]), place(server.init(params), sh[1]),
                        place(agg0, sh[2]), *(place(e, sh[7]) for e in extra))

            def out_carry(out):
                return out[:3] + ((out[3],) if tel else ())

            # two per-round rounds on the mesh
            step1, _, sh1, _ = build(mesh, None)
            c = carry(sh1)
            rounds = []
            for r in range(2):
                out = step1(*c[:3], place({k: v[r] for k, v in xs.items()}, sh1[3]),
                            place(tu[r], sh1[4]), place(td[r], sh1[5]), place(A, sh1[6]),
                            *c[3:])
                c, m = out_carry(out), out[-1]
                rounds.append(m)
            # one chunk of K = 2 on the mesh
            stepk, argk, shk, outk = build(mesh, 2)
            assert argk[3]["tokens"].shape[0] == 2 and argk[4].shape[0] == 2
            ck = carry(shk)
            out = stepk(*ck[:3], place(xs, shk[3]), place(tu, shk[4]), place(td, shk[5]),
                        place(A, shk[6]), *ck[3:])
            ck, mk = out_carry(out), out[-1]
            scan = stepk.__wrapped__
            assert scan._slot is not None and all(
                type(b).__name__ == "DTensor" for b in scan._slot.bufs
                if isinstance(b, torch.Tensor)), form
            assert all(type(x).__name__ == "DTensor" for x in tree.leaves(ck)), form
            for a, b in zip(tree.leaves(ck), tree.leaves(c)):
                assert a.placements == b.placements, form
                assert torch.equal(a.to_local(), b.to_local()), f"{form}: chunk != rounds"
            for key in stepk.metric_keys:
                got = [float(x) for x in mk[key]]
                want = [float(m[key]) for m in rounds]
                assert np.array_equal(got, want, equal_nan=True), (form, key, got, want)
            if tel:
                for key in ("client_participation", "client_uplink_bits", "outage_streak"):
                    # laid out by telemetry_rule(scan=True)
                    assert mk[key].placements == tuple(outk[4][key].placements()), key
                    got = whole(mk[key])
                    want = torch.stack([whole(m[key]) for m in rounds])
                    assert got.shape == (2, 4) and torch.equal(got, want), (form, key)
            p = tree.map(whole, ck[0])
            for path, x in zip(tree.paths(p), tree.leaves(p)):
                results[f"{form}:{path}"] = x.float().numpy()
            results[f"{form}:loss"] = mk["loss"].numpy()
        if rank == 0:
            np.savez(dest, **results)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        data, out = sys.argv[1], sys.argv[2]
        init = "file://" + os.path.join(tempfile.mkdtemp(), "init")
        mp.spawn(run, args=(4, init, data, out), nprocs=4, join=True)
        print("CHUNK_JOB_OK")
''')


def _jpath(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _inputs():
    """The reference's init and a chunk's batches and taus, as numpy."""
    cfg = jget_arch("qwen3-0.6b").smoke()
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(28)
    toks = rng.integers(0, cfg.vocab_size, size=(K, N, T, B, S + 1), dtype=np.int32)
    td = (rng.random((K, N, N)) < 0.7).astype(np.float32)
    td = np.maximum(td, np.swapaxes(td, 1, 2))
    td[:, np.arange(N), np.arange(N)] = 1.0
    A = rng.random((N, N)).astype(np.float32)
    inputs = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy(),
              "tau_up": np.array([[1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 1.0, 0.0]], np.float32),
              "tau_dd": td, "A": A / A.sum(1, keepdims=True)}
    return params, inputs


def _unsharded_chunk(params, inputs, form):
    """The port's K = 2 chunk of ``form`` without a mesh, from ``build_step``."""
    from repro_torch import strategies
    from repro_torch.configs.base import InputShape, get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.core import flatten
    from repro_torch.optim import sgd_momentum
    from repro_torch.telemetry.device import init_streak

    mode = "weighted_grad" if form == "weighted_grad" else "per_client"
    agg = "async_colrel" if form == "async_colrel" else "colrel"
    step, _, _, _ = steps.build_step("qwen3-0.6b", InputShape("t", S, B * N, "train"), None,
                                     n_clients=N, aggregation=agg, fl_mode=mode,
                                     cfg_override=get_arch("qwen3-0.6b").smoke(), scan_rounds=K,
                                     telemetry=form == "telemetry")
    p = tree.from_paths({_jpath(k): params_from_jax(np.asarray(x), "cpu") for k, x in
                         jax.tree_util.tree_flatten_with_path(params)[0]})
    xs = {k: torch.from_numpy(inputs[k]).long() for k in ("tokens", "labels")}
    if mode == "weighted_grad":
        xs = {k: v[:, :, 0] for k, v in xs.items()}
    server = sgd_momentum(1.0, beta=steps.SERVER_MOMENTUM)
    out = step(p, server.init(p), strategies.resolve(agg).init_state(N, flatten.flat_spec(p).d),
               xs, *(torch.from_numpy(inputs[k]) for k in ("tau_up", "tau_dd", "A")),
               *((init_streak(N),) if form == "telemetry" else ()))
    return dict(zip(tree.paths(out[0]), (x.float().numpy() for x in tree.leaves(out[0]))))


def _reference_chunk(params, inputs, form):
    """The reference's K = 2 chunk of ``form`` at ``build_step``'s settings."""
    cfg = jget_arch("qwen3-0.6b").smoke()
    mode = "weighted_grad" if form == "weighted_grad" else "per_client"
    agg = "async_colrel" if form == "async_colrel" else "colrel"
    tel = form == "telemetry"
    rc = JRoundConfig(n_clients=N, local_steps=jsteps.DRYRUN_LOCAL_STEPS, mode=mode,
                      aggregation=agg)
    make = jmake_async_scan_round_fn if form == "async_colrel" else jmake_scan_round_fn
    server = jsgd_momentum(1.0, beta=jsteps.SERVER_MOMENTUM)
    fn = make(jbuild(cfg).loss_fn, jsgd(jsteps.CLIENT_LR, weight_decay=jsteps.CLIENT_WD),
              server, rc, telemetry=tel)
    batches = {"tokens": jnp.asarray(inputs["tokens"]), "labels": jnp.asarray(inputs["labels"])}
    if mode == "weighted_grad":
        batches = {k: v[:, :, 0] for k, v in batches.items()}
    strategy = jstrategies.resolve(agg)
    d = sum(x.size for x in jax.tree.leaves(params))
    args = (params, server.init(params), strategy.init_state(N, d), batches,
            jnp.asarray(inputs["tau_up"]), jnp.asarray(inputs["tau_dd"]),
            jnp.asarray(inputs["A"]))
    out = jax.jit(fn)(*args, *((jinit_streak(N),) if tel else ()))
    return out[0], np.asarray(out[-1]["loss"])


@pytest.mark.parametrize("telemetry", [False, True], ids=["plain", "telemetry"])
@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "4x2"])
def test_build_scan_step_shardings_match_reference(mesh_name, telemetry):
    duck, amesh = _meshes(mesh_name)
    step, args, in_sh, out_sh = steps.build_step("qwen3-0.6b", "train_4k", duck, scan_rounds=K,
                                                 telemetry=telemetry)
    jstep, jargs, jin_sh, jout_sh = jsteps.build_step("qwen3-0.6b", "train_4k", amesh,
                                                      scan_rounds=K, telemetry=telemetry)
    _same(list(in_sh), list(jin_sh))
    _same(list(out_sh), list(jout_sh))
    assert len(args) == len(jargs)
    for a, ja in zip(args, jargs):
        assert [tuple(x.shape) for x in tree.leaves(a) if hasattr(x, "shape")] == \
            [tuple(x.shape) for x in jax.tree.leaves(ja)]
    assert all(v.shape[0] == K for v in args[3].values())
    assert args[4].shape[0] == K and args[5].shape[:1] == (K,)
    assert step.donate_argnums == jstep.donate_argnums
    assert set(step.metric_keys) - {"weight_drift"} == set(jout_sh[-1]) - {
        "weight_drift", "client_participation", "client_uplink_bits", "outage_streak"}


@pytest.mark.slow
def test_mesh_chunk_is_bitwise_its_rounds_and_matches_unsharded_and_reference(tmp_path):
    params, inputs = _inputs()
    data = tmp_path / "inputs.npz"
    flat = {f"p:{_jpath(p)}": np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(data, **flat, **inputs)
    out = tmp_path / "results.npz"
    script = tmp_path / "chunk_job.py"
    script.write_text(CHUNK_JOB)
    # the mesh's job runs while this process makes the unsharded and the
    # reference's chunks
    job = subprocess.Popen([sys.executable, str(script), str(data), str(out)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
                           cwd=ROOT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the job's ranks have the other cores
    try:
        wants = {form: (_unsharded_chunk(params, inputs, form),
                        *_reference_chunk(params, inputs, form)) for form in FORMS}
        stdout, stderr = job.communicate(timeout=300)
    finally:
        torch.set_num_threads(threads)
        if job.poll() is None:
            job.kill()
            job.wait()
    assert job.returncode == 0 and "CHUNK_JOB_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    got = np.load(out)
    for form, (plain, want, want_loss) in wants.items():
        for p, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            path = _jpath(p)
            mesh = got[f"{form}:{path}"]
            np.testing.assert_allclose(mesh, plain[path], atol=3e-5, rtol=3e-4,
                                       err_msg=f"{form} {path}: mesh vs unsharded chunk")
            np.testing.assert_allclose(mesh, np.asarray(w, np.float32), atol=3e-5, rtol=3e-4,
                                       err_msg=f"{form} {path}: mesh vs the reference's chunk")
        np.testing.assert_allclose(got[f"{form}:loss"], want_loss, atol=1e-4, rtol=0,
                                   err_msg=form)

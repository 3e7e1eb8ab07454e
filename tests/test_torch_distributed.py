"""The multi-device layer EXECUTING, the counterpart of
``tests/test_distributed_exec.py``: one ``per_client`` round on a real mesh
of gloo ranks on the CPU, held against the port's unsharded round and the
reference's single-device round, and the dry run's fake-group trace held
against a real run.

* 8 gloo ranks on a ``(4, 2)`` ``("data", "model")`` mesh run one round of
  qwen3-0.6b at ``smoke()`` (n = 4 clients, T = 2, B = 2, S = 32) under
  ``spmd_axes=("data",)``: each rank its data coordinate's client on the
  tensor-parallel ``model`` sub-mesh, the update stack a DTensor over the
  client axis.  Forms: colrel, colrel ``fused="collapse"``, colrel
  ``fused="kernel"`` (the plain contraction under ``spmd_axes``),
  clustered with C = 2, and the ``weighted_grad`` mode (T = 1, params and
  gradients also sharded fsdp-style over the data axis).  Params, batches
  and taus come from one set of numpy arrays (the reference's init
  converted); the reference's bar: ``atol=3e-5, rtol=3e-4``, loss within
  1e-4.
* 4 gloo ranks on a ``(2, 2)`` mesh run
  :func:`repro_torch.launch.dryrun.measure_mesh` on a round of the same
  model (the mesh's 2 clients, T = 2, 2 x 32 tokens a step); rank 0's FLOPs and
  collective bytes equal the fake-group trace's, and its peak is within
  10% of it.
* On a 1 x 1 mesh (a gloo group of one) the step ``build_step(arch,
  shape, mesh)`` builds is bitwise the round without a mesh (the kernel
  form, which contracts in plain ops on a mesh, against the collapse form).

Each rank runs one CPU thread (torch 2.13's CPU build corrupts its heap in
a oneDNN backward on several threads), and each job is a subprocess with
its own timeout.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import strategies as jstrategies
from repro.configs.base import get_arch as jget_arch
from repro.fl.round import RoundConfig as JRoundConfig, make_round_fn as jmake_round_fn
from repro.models import build as jbuild
from repro.optim import sgd as jsgd, sgd_momentum as jsgd_momentum

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
N, T, B, S, C = 4, 2, 2, 32, 2
FORMS = ("colrel", "collapse", "kernel", "clustered", "weighted_grad")
LR, BETA = 0.1, 0.9

ROUND_JOB = textwrap.dedent('''
    import os, sys, tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, init, data, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        from repro_torch import strategies, tree
        from repro_torch.convert import params_from_jax
        from repro_torch.configs.base import get_arch
        from repro_torch.dist import make_debug_mesh, use_mesh
        from repro_torch.dist.layout import distribute
        from repro_torch.fl.round import RoundConfig, make_round_fn
        from repro_torch.launch import sharding
        from repro_torch.models import build
        from repro_torch.optim import sgd, sgd_momentum

        z = np.load(data)
        mesh = make_debug_mesh(4, 2, device_type="cpu")
        cfg = get_arch("qwen3-0.6b").smoke()
        bundle = build(cfg)
        names = [k[2:] for k in z.files if k.startswith("p:")]
        params = tree.from_paths({k: params_from_jax(z["p:" + k], "cpu") for k in names})
        batches = {"tokens": torch.from_numpy(z["tokens"]).long(),
                   "labels": torch.from_numpy(z["labels"]).long()}
        taus = {"colrel": ("tau_up", "tau_dd", "A"), "clustered": ("tau_up", "btau_dd", "bA")}
        server = sgd_momentum(1.0, beta=0.9)
        psh = sharding.param_shardings(cfg, params, mesh)
        fsdp = sharding.param_shardings(cfg, params, mesh, fsdp=True)
        results = {}
        for form in ("colrel", "collapse", "kernel", "clustered", "weighted_grad"):
            agg = ("clustered" if form == "clustered" else
                   strategies.get("colrel", fused=form if form in ("collapse", "kernel")
                                  else False))
            tu, td, A = (torch.from_numpy(z[k]) for k in taus["clustered" if form == "clustered"
                                                             else "colrel"])
            # weighted_grad: the T = 1 collapse, (n, B, S) batches, params
            # and gradients sharded fsdp-style over the data axis too
            mode = "weighted_grad" if form == "weighted_grad" else "per_client"
            b = {k: v[:, 0] for k, v in batches.items()} if form == "weighted_grad" else batches
            shardings = fsdp if form == "weighted_grad" else psh
            for sharded in (False, True):
                if not sharded and rank != 0:
                    continue
                rc = RoundConfig(n_clients=4, local_steps=2, mode=mode, aggregation=agg,
                                 spmd_axes=("data",) if sharded else None)
                fn = make_round_fn(bundle.loss_fn, sgd(0.1), server, rc,
                                   grad_shardings=shardings if sharded and mode != "per_client"
                                   else None)
                if sharded:
                    dparams = tree.map(distribute, params, shardings)
                    with use_mesh(mesh):
                        p, _, _, m = fn(dparams, server.init(dparams), (), b, tu, td, A)
                    assert all(type(x).__name__ == "DTensor" and x.device_mesh == mesh
                               for x in tree.leaves(p))
                    p = tree.map(lambda x: x.full_tensor(), p)
                else:
                    p, _, _, m = fn(params, server.init(params), (), b, tu, td, A)
                tag = f"{form}:{int(sharded)}"
                results[tag + ":loss"] = np.float32(m["loss"])
                for path, x in zip(tree.paths(p), tree.leaves(p)):
                    results[f"{tag}:{path}"] = x.detach().float().numpy()
        if rank == 0:
            np.savez(out, **results)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        data, out = sys.argv[1], sys.argv[2]
        init = "file://" + os.path.join(tempfile.mkdtemp(), "init")
        mp.spawn(run, args=(8, init, data, out), nprocs=8, join=True)
        print("ROUND_JOB_OK")
''')

MEASURE_JOB = textwrap.dedent('''
    import json, os, sys, tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, init, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        from repro_torch.configs.base import InputShape, get_arch
        from repro_torch.dist import make_debug_mesh
        from repro_torch.launch import dryrun

        cfg = get_arch("qwen3-0.6b").smoke()
        shape = InputShape("t", 32, 4, "train")
        step, args, in_sh = dryrun.prepare_mesh("qwen3-0.6b", shape,
                                                make_debug_mesh(2, 2, device_type="cpu"), cfg=cfg)
        got = dryrun.measure_mesh(step, args, in_sh, vocab=cfg.vocab_size, device="cpu")
        if rank == 0:
            with open(out, "w") as f:
                json.dump(got, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        init = "file://" + os.path.join(tempfile.mkdtemp(), "init")
        mp.spawn(run, args=(4, init, sys.argv[1]), nprocs=4, join=True)
        print("MEASURE_JOB_OK")
''')


def _inputs():
    """Params (the reference's init), batches and taus as numpy arrays."""
    cfg = jget_arch("qwen3-0.6b").smoke()
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(N, T, B, S + 1), dtype=np.int32)
    td = (rng.random((N, N)) < 0.7).astype(np.float32)
    td = np.maximum(td, td.T)
    np.fill_diagonal(td, 1.0)
    btd = (rng.random((C, N // C, N // C)) < 0.7).astype(np.float32)
    btd = np.maximum(btd, np.swapaxes(btd, 1, 2))
    btd[:, np.arange(N // C), np.arange(N // C)] = 1.0
    A = rng.random((N, N)).astype(np.float32)
    inputs = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy(),
              "tau_up": np.array([1.0, 0.0, 1.0, 1.0], np.float32), "tau_dd": td,
              "A": A / A.sum(1, keepdims=True), "btau_dd": btd,
              "bA": np.full((C, N // C, N // C), 1.0 / (N // C), np.float32)}
    return params, inputs


def _reference_round(params, inputs, form):
    """The reference's single-device round of ``form`` on the inputs."""
    cfg = jget_arch("qwen3-0.6b").smoke()
    agg = ("clustered" if form == "clustered" else
           jstrategies.get("colrel", fused=form if form in ("collapse", "kernel") else False))
    keys = ("tau_up", "btau_dd", "bA") if form == "clustered" else ("tau_up", "tau_dd", "A")
    server = jsgd_momentum(1.0, beta=BETA)
    mode = "weighted_grad" if form == "weighted_grad" else "per_client"
    fn = jmake_round_fn(jbuild(cfg).loss_fn, jsgd(LR), server,
                        JRoundConfig(n_clients=N, local_steps=T, mode=mode, aggregation=agg))
    batches = {"tokens": jnp.asarray(inputs["tokens"]), "labels": jnp.asarray(inputs["labels"])}
    if mode == "weighted_grad":  # the T = 1 collapse: (n, B, S)
        batches = {k: v[:, 0] for k, v in batches.items()}
    p, _, _, m = jax.jit(fn)(params, server.init(params), (), batches,
                            *(jnp.asarray(inputs[k]) for k in keys))
    return p, float(m["loss"])


def _run_job(tmp_path, name, source, *argv):
    """``source`` as a script file (spawned ranks import their function from
    it), run in a subprocess with its own timeout."""
    script = tmp_path / f"{name}.py"
    script.write_text(source)
    run = subprocess.run([sys.executable, str(script), *map(str, argv)], capture_output=True,
                         text=True, env=ENV, cwd=ROOT, timeout=300)
    assert run.returncode == 0 and f"{name.upper()}_OK" in run.stdout, \
        run.stdout[-2000:] + run.stderr[-4000:]


def _jpath(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.slow
def test_sharded_round_on_eight_gloo_ranks_matches_unsharded_and_reference(tmp_path):
    params, inputs = _inputs()
    data = tmp_path / "inputs.npz"
    flat = {f"p:{_jpath(p)}": np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(data, **flat, **inputs)
    out = tmp_path / "results.npz"
    _run_job(tmp_path, "round_job", ROUND_JOB, data, out)
    got = np.load(out)
    for form in FORMS:
        want, want_loss = _reference_round(params, inputs, form)
        wl = {_jpath(p): np.asarray(x, np.float32)
              for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
        for path, w in wl.items():
            sharded, unsharded = got[f"{form}:1:{path}"], got[f"{form}:0:{path}"]
            np.testing.assert_allclose(sharded, unsharded, atol=3e-5, rtol=3e-4,
                                       err_msg=f"{form} {path}: sharded vs unsharded")
            np.testing.assert_allclose(sharded, w, atol=3e-5, rtol=3e-4,
                                       err_msg=f"{form} {path}: sharded vs the reference")
        assert abs(float(got[f"{form}:1:loss"]) - want_loss) < 1e-4, form
        assert abs(float(got[f"{form}:1:loss"]) - float(got[f"{form}:0:loss"])) < 1e-4, form


@pytest.mark.slow
def test_fake_group_trace_matches_a_real_four_rank_run(tmp_path):
    import json

    from repro_torch.configs.base import InputShape, get_arch
    from repro_torch.dist import make_debug_mesh
    from repro_torch.launch import dryrun

    out = tmp_path / "measure.json"
    _run_job(tmp_path, "measure_job", MEASURE_JOB, out)
    real = json.loads(out.read_text())
    cfg = get_arch("qwen3-0.6b").smoke()
    with dryrun.fake_group(4):
        step, args, in_sh = dryrun.prepare_mesh("qwen3-0.6b", InputShape("t", 32, 4, "train"),
                                                make_debug_mesh(2, 2, device_type="cpu"),
                                                cfg=cfg)
        fake = dryrun.trace_mesh(step, args, in_sh)
    assert real["finite"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["collectives"] == real["collectives"] and sum(real["collectives"].values()) > 0
    assert abs(fake["peak_bytes"] - real["peak_bytes"]) <= 0.10 * real["peak_bytes"]
    assert fake["argument_bytes"] == real["argument_bytes"]


@pytest.mark.slow
@pytest.mark.parametrize("form", ["colrel", "kernel"])
def test_one_by_one_mesh_round_is_bitwise_the_round_without_a_mesh(form, tmp_path):
    """On a 1 x 1 mesh (a gloo group of one) the step ``build_step(arch,
    shape, mesh)`` builds runs the one device's arithmetic: bitwise the
    round without a mesh, with the same contraction, as ``chip_smoke.py``
    phase 14 holds it on the card with NCCL.  The kernel form contracts the
    flat stack against the collapsed weights in plain ops on a mesh, so it
    is held to the collapse form without one (``spmd_axes`` is inert
    there: that round would take the kernel's route)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import strategies, tree
    from repro_torch.configs.base import InputShape, get_arch
    from repro_torch.dist import make_debug_mesh
    from repro_torch.fl.round import RoundConfig, make_round_fn
    from repro_torch.launch.steps import CLIENT_LR, CLIENT_WD, build_step, place
    from repro_torch.models import build
    from repro_torch.optim import sgd, sgd_momentum

    torch.set_num_threads(1)
    cfg = get_arch("qwen3-0.6b").smoke()
    agg = strategies.get("colrel", fused=False if form == "colrel" else form)
    plain_agg = strategies.get("colrel", fused=False if form == "colrel" else "collapse")
    shape = InputShape("t", S, B * N, "train")
    g = torch.Generator().manual_seed(3)
    params = build(cfg).init(g)
    toks = torch.randint(0, cfg.vocab_size, (N, 3, B, S + 1), generator=g)
    batches = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
    A = torch.full((N, N), 1.0 / N)
    tau_up = torch.tensor([1.0, 1.0, 0.0, 1.0])
    tau_dd = (torch.rand(N, N, generator=g) < 0.7).float()
    server = sgd_momentum(1.0, beta=0.9)
    plain = make_round_fn(build(cfg).loss_fn, sgd(CLIENT_LR, weight_decay=CLIENT_WD), server,
                          RoundConfig(n_clients=N, local_steps=3, aggregation=plain_agg))
    want = plain(params, server.init(params), (), batches, tau_up, tau_dd, A)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        step, _, in_sh, _ = build_step("qwen3-0.6b", shape, mesh, n_clients=N, aggregation=agg,
                                       cfg_override=cfg)
        dparams = place(params, in_sh[0])
        got = step(dparams, server.init(dparams), (), batches, tau_up, tau_dd, A)
    finally:
        dist.destroy_process_group()
    assert all(isinstance(x, DTensor) and x.device_mesh == mesh for x in tree.leaves(got[0]))
    for a, b in zip(tree.leaves(got[0]) + tree.leaves(got[1]["m"]),
                    tree.leaves(want[0]) + tree.leaves(want[1]["m"])):
        assert torch.equal(a.to_local(), b)
    assert {k: float(v) for k, v in got[3].items()} == {k: float(v) for k, v in want[3].items()}

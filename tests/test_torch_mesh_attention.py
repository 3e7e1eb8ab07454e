"""The attention's own layout on a mesh (``dist/layout.py``:
``heads_layout``, ``attend_sequence_sharded``).

* One gloo job of 8 ranks on a ``(2, 4)`` ``("data", "model")`` mesh runs
  qwen3-0.6b at ``smoke()`` (4 query heads over 2 kv heads, so ``model`` = 4
  shards the query heads but not the kv heads: k and v reach the attention
  as pending sums, and a decode cache is sharded over its sequence), with
  query blocks of 8 (``attn_chunk``) and, in a second form, a sliding
  window of 12 and logit soft-capping.  Through the steps ``build_step``
  builds on the mesh and without one, on the same inputs:

  - the prefill (4 x 32 tokens): the last-position logits;
  - one decode step at ``pos`` = 20 against a random 4 x 32 cache (the
    fourth model rank's slots all lie past ``pos``): the logits and the
    cache slot written;
  - one ``per_client`` round (2 clients, T = 1, ``spmd_axes=("data",)``):
    the params after it, so that the layout's backward is held too.

  Forward values within ``atol=rtol=2e-5`` (f32, another order of the
  softmax's sums); the round at the reference's ``atol=3e-5, rtol=3e-4``.
* The fake-group dry run of qwen3-0.6b at full width cut to one layer on
  the reference's 16 x 16 mesh: ``decode_32k`` moves at most 1.71e6
  collective bytes a device (the f32 logits' 1.68e7 B all-gather over the
  sequence-sharded cache is gone) and ``attend_sequence_sharded``'s
  reductions are one ``(8, 1, 16, 128)`` f32 output and two ``(8, 16)`` f32
  vectors; ``prefill_32k`` runs ``aten.bmm`` on each device's own 2
  requests x 1 head (within 5% of the core's ``QK^T`` and ``PV``,
  1.0995e12 FLOPs) and all-reduces no logits.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
FWD_TOL = 2e-5

ATTENTION_JOB = textwrap.dedent('''
    import os, sys, tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, init, dest):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        from repro_torch import tree
        from repro_torch.configs.base import InputShape, get_arch
        from repro_torch.dist import make_debug_mesh, use_mesh
        from repro_torch.fl.round import RoundConfig, make_round_fn
        from repro_torch.launch import sharding
        from repro_torch.launch.steps import build_step, place
        from repro_torch.models import build
        from repro_torch.optim import sgd, sgd_momentum

        mesh = make_debug_mesh(2, 4, device_type="cpu")
        base = get_arch("qwen3-0.6b").smoke().replace(attn_chunk=8)
        forms = {"plain": base,
                 "window": base.replace(sliding_window=12, attn_logit_softcap=20.0)}
        res = {}

        def whole(x):
            return x.full_tensor() if hasattr(x, "full_tensor") else x

        for form, cfg in forms.items():
            g = torch.Generator().manual_seed(28)
            params = build(cfg).init(g)
            toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
            # the prefill
            pre = InputShape("p", 32, 4, "prefill")
            step, _, sh, _ = build_step("qwen3-0.6b", pre, mesh, cfg_override=cfg)
            got = whole(step(place(params, sh[0]), place({"tokens": toks}, sh[1])))
            res[f"{form}:prefill:mesh"] = got.numpy()
            if rank == 0:
                plain = build_step("qwen3-0.6b", pre, None, cfg_override=cfg)[0]
                res[f"{form}:prefill:plain"] = plain(params, {"tokens": toks}).numpy()
            # one decode step against a random cache
            dec = InputShape("d", 32, 4, "decode")
            step, args, sh, _ = build_step("qwen3-0.6b", dec, mesh, cfg_override=cfg)
            assert sh[1]["k"].spec[2] == "model", sh[1]["k"].spec  # sequence-sharded
            cache = tree.map(lambda t: torch.randn(t.shape, generator=g), args[1])
            token = toks[:, 7:8]
            logits, new = step(place(params, sh[0]), place(tree.map(torch.clone, cache), sh[1]),
                               place(token, sh[2]), 20)
            res[f"{form}:decode:mesh"] = whole(logits).numpy()
            res[f"{form}:slot:mesh"] = whole(new["k"])[:, :, 20].numpy()
            if rank == 0:
                plain = build_step("qwen3-0.6b", dec, None, cfg_override=cfg)[0]
                logits, new = plain(params, cache, token, 20)
                res[f"{form}:decode:plain"] = logits.numpy()
                res[f"{form}:slot:plain"] = new["k"][:, :, 20].numpy()
        # one per_client round: the layout's backward
        cfg = base
        g = torch.Generator().manual_seed(7)
        params = build(cfg).init(g)
        toks = torch.randint(0, cfg.vocab_size, (2, 1, 2, 33), generator=g)
        batches = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
        tu, td, A = torch.ones(2), torch.ones(2, 2), torch.full((2, 2), 0.5)
        server = sgd_momentum(1.0, beta=0.9)
        for sharded in (True, False):
            if not sharded and rank != 0:
                continue
            rc = RoundConfig(n_clients=2, local_steps=1, spmd_axes=("data",) if sharded else None)
            fn = make_round_fn(build(cfg).loss_fn, sgd(0.1), server, rc)
            p = params
            if sharded:
                p = place(params, sharding.param_shardings(cfg, params, mesh))
                with use_mesh(mesh):
                    p = fn(p, server.init(p), (), batches, tu, td, A)[0]
            else:
                p = fn(p, server.init(p), (), batches, tu, td, A)[0]
            for path, x in zip(tree.paths(p), tree.leaves(p)):
                res[f"round:{int(sharded)}:{path}"] = whole(x).detach().numpy()
        if rank == 0:
            np.savez(dest, **res)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        init = "file://" + os.path.join(tempfile.mkdtemp(), "init")
        mp.spawn(run, args=(8, init, sys.argv[1]), nprocs=8, join=True)
        print("ATTENTION_JOB_OK")
''')


@pytest.mark.slow
def test_sharded_prefill_decode_and_round_match_unsharded(tmp_path):
    out = tmp_path / "results.npz"
    script = tmp_path / "attention_job.py"
    script.write_text(ATTENTION_JOB)
    run = subprocess.run([sys.executable, str(script), str(out)], capture_output=True,
                         text=True, env=ENV, cwd=ROOT, timeout=300)
    assert run.returncode == 0 and "ATTENTION_JOB_OK" in run.stdout, \
        run.stdout[-2000:] + run.stderr[-4000:]
    got = np.load(out)
    for form in ("plain", "window"):
        for what in ("prefill", "decode", "slot"):
            np.testing.assert_allclose(got[f"{form}:{what}:mesh"], got[f"{form}:{what}:plain"],
                                       atol=FWD_TOL, rtol=FWD_TOL, err_msg=f"{form} {what}")
    paths = [k[len("round:1:"):] for k in got.files if k.startswith("round:1:")]
    assert paths
    for path in paths:
        np.testing.assert_allclose(got[f"round:1:{path}"], got[f"round:0:{path}"],
                                   atol=3e-5, rtol=3e-4, err_msg=path)


def _one_layer_trace(shape_name):
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import make_production_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import attention

    seen = {}
    real = attention.attend_sequence_sharded

    def watched(q, k, v, scores):
        out = real(q, k, v, scores)
        seen.update(q=tuple(q.shape), out=tuple(out.to_local().shape))
        return out

    attention.attend_sequence_sharded = watched
    try:
        with dryrun.fake_group(256):
            mesh = make_production_mesh(multi_pod=False, device_type="cpu")
            step, args, in_sh = dryrun.prepare_mesh(
                "qwen3-0.6b", shape_name, mesh, cfg=get_arch("qwen3-0.6b").full().replace(
                    n_layers=1))
            rec = dryrun.trace_mesh(step, args, in_sh)
    finally:
        attention.attend_sequence_sharded = real
    return rec, seen


def test_sequence_sharded_decode_reduces_the_softmax_not_the_logits():
    rec, seen = _one_layer_trace("decode_32k")
    coll = rec["collectives"]
    assert sum(coll.values()) <= 1.71e6, coll
    # the local output the last all-reduce sums, (8, 1, 16, 128) f32: the
    # batch of one data coordinate, every head
    assert seen == {"q": (128, 1, 16, 128), "out": (8, 1, 16, 128)}, seen


def test_sharded_prefill_attends_each_devices_own_heads():
    rec, _ = _one_layer_trace("prefill_32k")
    core = 2 * (2 * 2 * 1 * 32768 * 32768 * 128)  # QK^T and PV, 2 requests x 1 head
    bmm = rec["flops_by_op"]["aten.bmm"]
    assert core <= bmm <= 1.05 * core, bmm
    # no f32 logits all-reduced: one head's over the layer's 16 query blocks,
    # (2, 1, 2048, 32768) f32 each, would alone be 8.6e9 B
    assert rec["collectives"]["all-reduce"] < 16 * 2 * 2048 * 32768 * 4, rec["collectives"]

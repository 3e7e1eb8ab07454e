"""The checkpoint writer's per-shard path (the reference's
``src/repro/ckpt/writer.py`` snapshot of addressable shards and its
``_reassemble``), on a mesh of gloo ranks.

One gloo job of 4 ranks on a ``(2, 2)`` ``("data", "model")`` mesh runs
qwen3-0.6b at ``smoke()`` (n = 4 clients) through the chunked ``async_colrel``
step that ``build_step(..., scan_rounds=2)`` builds on the mesh (the params
over ``model``, the ``(n, d)`` staging buffer over ``data``):

* chunk 1, a per-shard save of its carry (step 2), chunk 2 and a save of
  its carry (step 4), then a restore of step 2 laid out by
  ``train_state_shardings`` into the step's static buffers: chunk 2 again
  is bitwise the uninterrupted one;
* each rank's payload holds only its own shards, with the bounds
  ``compute_local_shape_and_global_offset`` gives, and a shard replicated
  over a mesh dim only where this rank's coordinate there is 0;
* a save of step 6 with ``keep=2`` deletes every rank's step-2 files;
* a leaf with a pending partial sum is refused with a ``ValueError`` that
  names it.

The test process then reads the directory without a process group: the
committed steps are 4 and 6, step 4 reassembles bitwise the whole state the
job gathered, its shards hold each element once, and with one rank's
sidecar gone step 6 is no longer committed.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.ckpt.writer import CheckpointWriter

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}

CKPT_JOB = textwrap.dedent('''
    import os, sys, tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def pairs(rec, x):
        """(sharded record, the DTensor it was made from) over a state tree."""
        if isinstance(x, dict):
            return [p for k in x for p in pairs(rec[k], x[k])]
        if isinstance(x, (list, tuple)):
            return [p for r, y in zip(rec, x) for p in pairs(r, y)]
        return [(rec, x)]

    def run(rank, world, init, ckdir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        from repro_torch import strategies, tree
        from repro_torch.checkpoint import io as ckpt_io
        from repro_torch.ckpt.writer import AsyncCheckpointer, CheckpointWriter, snapshot
        from repro_torch.configs.base import InputShape, get_arch
        from repro_torch.core import flatten
        from repro_torch.dist import make_debug_mesh
        from repro_torch.launch.steps import (SERVER_MOMENTUM, build_step, place,
                                              train_state_shardings)
        from repro_torch.models import build
        from repro_torch.optim import sgd_momentum

        mesh = make_debug_mesh(2, 2, device_type="cpu")
        cfg = get_arch("qwen3-0.6b").smoke()
        shape = InputShape("t", 32, 8, "train")
        g = torch.Generator().manual_seed(28)
        params = build(cfg).init(g)
        server = sgd_momentum(1.0, beta=SERVER_MOMENTUM)
        agg = "async_colrel"
        agg0 = strategies.resolve(agg).init_state(4, flatten.flat_spec(params).d)

        def chunk_inputs():
            toks = torch.randint(0, cfg.vocab_size, (2, 4, 2, 2, 33), generator=g)
            return ({"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()},
                    (torch.rand(2, 4, generator=g) < 0.6).float(),
                    (torch.rand(2, 4, 4, generator=g) < 0.7).float())

        step, _, sh, _ = build_step("qwen3-0.6b", shape, mesh, n_clients=4, aggregation=agg,
                                    cfg_override=cfg, scan_rounds=2)
        A = place(torch.full((4, 4), 0.25), sh[6])
        inputs = [chunk_inputs() for _ in range(2)]

        def chunk(step_, carry, c):
            xs, tu, td = inputs[c]
            out = step_(*carry, place(xs, sh[3]), place(tu, sh[4]), place(td, sh[5]), A)
            return out[:3]

        def state(carry):
            return dict(zip(("params", "server_state", "agg_state"), carry))

        def locals_(carry):
            return [x.to_local().clone() for x in tree.leaves(carry)]

        ck = AsyncCheckpointer(ckdir, keep=0)
        c0 = (place(params, sh[0]), place(server.init(params), sh[1]), place(agg0, sh[2]))
        c1 = chunk(step, c0, 0)
        ck.save(2, state(c1))
        saved = locals_(c1)
        c2 = chunk(step, c1, 1)
        ck.save(4, state(c2))
        ck.wait()
        want = locals_(c2)
        whole = tree.map(lambda x: x.full_tensor(), state(c2))

        # each rank's payload: its own shards alone
        own = ckpt_io.from_bytes(CheckpointWriter(ckdir).path_for(4).read_bytes())
        coord = mesh.get_coordinate()
        for rec, x in pairs(own, state(c2)):
            writes = all(c == 0 for c, p in zip(coord, x.placements) if p.is_replicate())
            assert len(rec["shards"]) == int(writes), rec["shape"]
            if writes:
                n, start = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
                sh0 = rec["shards"][0]
                assert sh0["start"] == list(start) and sh0["stop"] == [
                    a + b for a, b in zip(start, n)]
                assert torch.equal(sh0["data"], x.to_local())
        assert saved[0].numel() > 0

        # restore step 2 into the step's static buffers
        st = train_state_shardings("qwen3-0.6b", shape, mesh, aggregation=agg, cfg_override=cfg)
        back = CheckpointWriter(ckdir).load(2)
        restored = tuple(place(back[k], st[k]) for k in ("params", "server_state", "agg_state"))
        assert all(torch.equal(a, b) for a, b in zip(locals_(restored), saved))
        again = chunk(step, restored, 1)
        assert all(torch.equal(a, b) for a, b in zip(locals_(again), want)), \\
            "resumed chunk != uninterrupted"

        # retention: every rank deletes its own files of step 2
        ck.writer.keep = 2
        ck.save(6, state(c2))
        ck.close()

        # a pending partial sum is refused by name
        bad = DTensor.from_local(torch.ones(2), mesh, [Replicate(), Partial()])
        try:
            snapshot({"params": {"bad": bad}})
            raise AssertionError("a Partial leaf was snapshotted")
        except ValueError as e:
            assert "/params/bad" in str(e) and "partial" in str(e), e
        if rank == 0:
            torch.save(whole, os.path.join(ckdir, "whole.pt"))
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        init = "file://" + os.path.join(tempfile.mkdtemp(), "init")
        mp.spawn(run, args=(4, init, sys.argv[1]), nprocs=4, join=True)
        print("CKPT_JOB_OK")
''')


def _records(t):
    """The sharded records of a decoded payload, in tree order."""
    if isinstance(t, dict) and "__sharded__" in t:
        return [t]
    vals = t.values() if isinstance(t, dict) else t if isinstance(t, (list, tuple)) else []
    return [r for v in vals for r in _records(v)]


@pytest.mark.slow
def test_sharded_checkpoint_on_four_gloo_ranks(tmp_path):
    ckdir = tmp_path / "ck"
    script = tmp_path / "ckpt_job.py"
    script.write_text(CKPT_JOB)
    run = subprocess.run([sys.executable, str(script), str(ckdir)], capture_output=True,
                         text=True, env=ENV, cwd=ROOT, timeout=300)
    assert run.returncode == 0 and "CKPT_JOB_OK" in run.stdout, \
        run.stdout[-2000:] + run.stderr[-4000:]
    names = sorted(p.name for p in ckdir.glob("ckpt_*"))
    assert not [n for n in names if n.startswith("ckpt_00000002")], names
    assert len([n for n in names if n.endswith(".pt")]) == 8, names
    reader = CheckpointWriter(ckdir)
    assert (reader.rank, reader.world) == (0, 1) and reader.steps() == [4, 6]
    whole = torch.load(ckdir / "whole.pt", weights_only=True)
    back = reader.load(4)
    assert tree.paths(back) == tree.paths(whole)
    for a, b in zip(tree.leaves(back), tree.leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # every element written once, by one rank
    payloads = [ckpt_io.from_bytes((ckdir / f"ckpt_00000004.rank{r}of4.pt").read_bytes())
                for r in range(4)]
    written = sum(sh["data"].numel() for p in payloads for rec in _records(p)
                  for sh in rec["shards"])
    assert written == sum(x.numel() for x in tree.leaves(whole))
    (ckdir / "ckpt_00000006.rank3of4.pt.sha256").unlink()
    assert reader.steps() == [4]
    with pytest.raises(FileNotFoundError, match="not committed"):
        reader.load(6)

"""The port's counterpart of ``tests/conformance.py``: one tiny fixture over
every registered port strategy and every execution engine, and the bitwise
comparison of two runs.

The fixture is the reference's least-squares problem (n=6 clients, d=12,
T=2, 64 samples a client) over a Gilbert–Elliott channel with a block of 4 rounds, so a 6-round
run crosses a buffer refill and a resume at round 3 regenerates a block in
the middle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import strategies, tree
from repro_torch.channel import (
    ClusteredMarkovChannel,
    MarkovChannel,
    gilbert_elliott,
    gilbert_elliott_clustered,
)
from repro_torch.core import topology
from repro_torch.core.weights import optimize_weights, optimize_weights_clustered
from repro_torch.data.pipeline import ClientDataset
from repro_torch.fl.trainer import FLTrainer
from repro_torch.optim import sgd, sgd_momentum

N, D = 6, 12

#: name -> (FLTrainer mode, run() kwargs), as the reference's matrix
EXECUTION_MODES = {
    "per_round": ("per_client", dict(chunk=1)),
    "chunked": ("per_client", dict(chunk=3)),
    "no_trace": ("per_client", dict(chunk=3, no_trace=True)),
    "async": ("async", dict(chunk=3)),
}


def strategy_names():
    return sorted(strategies.available())


@functools.lru_cache(maxsize=None)
def fixture(strategy: str):
    """(link model, alpha): the clustered scheme gets the block topology
    with block COPT-alpha, every other the fully connected model."""
    if strategy == "clustered":
        model = topology.clustered_blocks(N, 0.5, 3, p_intra=0.8, rho=0.6)
        return model, np.asarray(optimize_weights_clustered(model, sweeps=5,
                                                            fine_tune_sweeps=5).Ab)
    model = topology.fully_connected(N, 0.5, p_c=0.8, rho=1.0)
    return model, np.asarray(optimize_weights(model, sweeps=5, fine_tune_sweeps=5).A)


def channel(strategy: str, model, *, seed=5, block=4):
    if strategy == "clustered":
        return ClusteredMarkovChannel(gilbert_elliott_clustered(model, memory=0.8),
                                      seed=seed, block=block)
    return MarkovChannel(gilbert_elliott(model, memory=0.8), seed=seed, block=block)


def make_trainer(strategy: str = "colrel", mode: str = "per_round", *, device="cpu",
                 **trainer_kw) -> FLTrainer:
    # distinct samples (the reference's fixture repeats one), so a resume
    # that drew the wrong batches would show
    rng = np.random.default_rng(0)
    targets = rng.normal(size=(N, 1, D)) + 0.5 * rng.normal(size=(N, 64, D))
    clients = [ClientDataset({"t": targets[i].astype(np.float32)}, batch_size=4, seed=i)
               for i in range(N)]
    model, A = fixture(strategy)

    def loss_fn(p, batch):
        r = p["x"] - batch["t"]
        return torch.mean(r * r), None

    kw = dict(local_steps=2, strategy=strategy, seed=3, channel=channel(strategy, model),
              mode=EXECUTION_MODES[mode][0], device=device)
    kw.update(trainer_kw)
    return FLTrainer(loss_fn, {"x": torch.zeros(D)}, model, A, clients, sgd(0.3),
                     sgd_momentum(1.0, beta=0.9), **kw)


def run_kwargs(mode: str) -> dict:
    return dict(EXECUTION_MODES[mode][1])


def _same_leaves(a, b, what):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        if x is None:
            assert y is None, what
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), what
        else:
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), what


def assert_same_run(a: FLTrainer, b: FLTrainer) -> None:
    """Every TrainLog stream, every scalar the round returned, the vector
    histories, params, server state, strategy state (generators by their
    state), the streak and the ``no_trace`` carry: bitwise."""
    for field, av in a.log.to_dict().items():
        bv = getattr(b.log, field)
        assert len(av) == len(bv), field
        for x, y in zip(av, bv):
            assert x == y or (np.isnan(x) and np.isnan(y)), (field, x, y)
    assert a.round_metrics.keys() == b.round_metrics.keys()
    for k, v in a.round_metrics.items():
        np.testing.assert_array_equal(v, b.round_metrics[k], err_msg=k)
    for name in ("client_participation", "client_uplink_bits", "outage_streak"):
        va, vb = a.metrics.vector(name), b.metrics.vector(name)
        assert (va is None) == (vb is None), name
        if va is not None:
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb, err_msg=name)
    for name in ("params", "server_state", "agg_state", "_streak", "_channel_state",
                 "_channel_gen"):
        _same_leaves(getattr(a, name), getattr(b, name), name)
    assert a.round == b.round
    np.testing.assert_array_equal(a.A.cpu().numpy(), b.A.cpu().numpy())

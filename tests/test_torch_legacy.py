"""The reference's legacy aggregation spellings on the port, held to the
reference's warnings and to the rounds of the spellings they stand for:
``Aggregation`` and ``aggregate``, the ``colrel_fused`` alias,
``resolve(fused_kernel=)``, ``RoundConfig``'s ``use_fused_kernel``,
``use_flash``, ``unroll`` and ``spmd_axes``, and
``FLTrainer(aggregation=, use_fused_kernel=)``.

Each spelling must warn with the reference's message and run bitwise the
round of ``colrel`` with the matching ``fused=`` (both on the CPU, where a
kernel path takes its kernel's plain version).
"""

import warnings

import numpy as np
import pytest
import torch

from repro import strategies as jstrategies
from repro.core.aggregation import Aggregation as JAggregation
from repro.core.aggregation import aggregate as jaggregate
from repro.fl.round import RoundConfig as JRoundConfig
from repro_torch import strategies, tree
from repro_torch.core import Aggregation, aggregate, fedavg_weights, topology
from repro_torch.fl import FLTrainer, RoundConfig, make_round_fn
from repro_torch.fl.experiment import ExperimentSpec, build_task

N = 10
ROUNDS = 3


def _reference_message(fn) -> str:
    with pytest.warns(DeprecationWarning) as rec:
        fn()
    return str(rec[0].message)


FUSED_MSG = _reference_message(lambda: jstrategies.get("colrel_fused"))
KERNEL_MSG = _reference_message(lambda: jstrategies.resolve("colrel", fused_kernel=True))


def test_enum_values_equal_the_reference():
    assert [(m.name, m.value) for m in Aggregation] == [(m.name, m.value) for m in JAggregation]
    assert all(isinstance(m, str) for m in Aggregation)


def test_registry_spellings_warn_as_the_reference():
    with pytest.warns(DeprecationWarning) as rec:
        s = strategies.get(Aggregation.COLREL_FUSED)
    assert str(rec[0].message) == FUSED_MSG and s.fused == "collapse"
    with pytest.warns(DeprecationWarning) as rec:
        s = strategies.resolve("colrel", fused_kernel=True)
    assert str(rec[0].message) == KERNEL_MSG and s.fused == "kernel"
    with pytest.warns(DeprecationWarning):
        s = strategies.resolve(strategies.get("colrel"), fused_kernel=True)
    assert s.fused == "kernel"
    with pytest.raises(ValueError, match="only applies to the colrel strategy"):
        strategies.resolve("fedavg_blind", fused_kernel=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert strategies.canonical_name("colrel_fused") == "colrel"
        assert strategies.canonical_name(Aggregation.FEDAVG_BLIND) == "fedavg_blind"
        assert strategies.get(Aggregation.COLREL).fused is False
    assert "colrel_fused" not in strategies.available()
    assert "colrel_fused" in strategies.available(include_deprecated=True)
    with pytest.raises(KeyError, match="unknown aggregation strategy"):
        strategies.canonical_name("nope")
    with pytest.raises(ValueError, match="already registered"):
        strategies.register_deprecated_alias("colrel", "colrel", "x")


@pytest.mark.parametrize("spelling", list(Aggregation), ids=lambda m: m.value)
def test_aggregate_equals_the_reference(spelling):
    rng = np.random.default_rng(3)
    n, d = 6, 37
    updates = rng.normal(size=(n, d)).astype(np.float32)
    tau_up = (rng.random(n) < 0.6).astype(np.float32)
    tau_dd = (rng.random((n, n)) < 0.5).astype(np.float32)
    np.fill_diagonal(tau_dd, 1.0)
    A = rng.random((n, n)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = aggregate(spelling, torch.from_numpy(updates), tau_up=torch.from_numpy(tau_up),
                        tau_dd=torch.from_numpy(tau_dd), A=torch.from_numpy(A))
        want = jaggregate(JAggregation(spelling.value), updates, tau_up=tau_up, tau_dd=tau_dd,
                          A=A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    if strategies.get(strategies.canonical_name(spelling)).needs_A:
        with pytest.raises(ValueError, match="needs A and tau_dd"), warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            aggregate(spelling, torch.from_numpy(updates), tau_up=torch.from_numpy(tau_up))


def test_round_config_takes_the_reference_fields():
    rc = RoundConfig(n_clients=4, local_steps=1, use_fused_kernel=True, use_flash=True,
                     unroll=True, spmd_axes=("data",))
    jrc = JRoundConfig(n_clients=4, local_steps=1, use_fused_kernel=True, use_flash=True,
                       unroll=True, spmd_axes=("data",))
    for field in ("use_fused_kernel", "use_flash", "unroll", "spmd_axes"):
        assert getattr(rc, field) == getattr(jrc, field)
    with pytest.warns(DeprecationWarning) as rec:
        s = rc.resolve_strategy()
    assert str(rec[0].message) == KERNEL_MSG and s.name == "colrel" and s.fused == "kernel"
    with pytest.raises(ValueError, match="only applies to the colrel strategy"):
        RoundConfig(n_clients=4, local_steps=1, aggregation="fedavg_blind",
                    use_fused_kernel=True)
    with pytest.raises(KeyError):
        RoundConfig(n_clients=4, local_steps=1, aggregation="nope")


def _task():
    loss_fn, init, clients, copt, sopt, _, _ = build_task(ExperimentSpec(model="quadratic"), N,
                                                          "cpu")
    return loss_fn, init, clients, copt, sopt


def test_inert_round_config_fields_leave_the_round_bitwise():
    """``use_flash`` and ``unroll`` are accepted and read by nothing, and
    ``spmd_axes`` is inert outside a mesh: the round with them is bitwise
    the round without."""
    loss_fn, init, clients, copt, sopt = _task()
    batches = {k: torch.as_tensor(v) for k, v in clients[0].next_batches(2).items()}
    batches = tree.map(lambda x: x[None].expand(N, *x.shape).contiguous(), batches)
    g = torch.Generator().manual_seed(0)
    tau_up = (torch.rand(N, generator=g) < 0.7).float()
    tau_dd = (torch.rand(N, N, generator=g) < 0.5).float()
    A = torch.as_tensor(fedavg_weights(N), dtype=torch.float32)
    outs = []
    for extra in ({}, {"use_flash": True, "unroll": True, "spmd_axes": ("data",)}):
        rc = RoundConfig(n_clients=N, local_steps=2, **extra)
        fn = make_round_fn(loss_fn, copt, sopt, rc)
        outs.append(fn(init, sopt.init(init), (), batches, tau_up, tau_dd, A))
    (p0, s0, _, m0), (p1, s1, _, m1) = outs
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p0), tree.leaves(p1)))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(s0), tree.leaves(s1)))
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}


# (strategy, segment_d, the ops entry its kernel route calls once a round)
KERNEL_ROUTES = {
    "colrel": ("colrel", 0, "fused_aggregate"),
    "colrel_segments": ("colrel", 1, "row_stream_segments"),
    "clustered": ("clustered", 0, "block_fused_aggregate"),
    "clustered_segments": ("clustered", 1, "block_row_stream_segments"),
    "memory": ("memory", 0, "fused_memory_update"),
    "memory_segments": ("memory", 1, "memory_stream_segments"),
    "quantized": ("quantized", 0, "fused_dequant_aggregate"),
    "quantized_segments": ("quantized", 1, "row_stream_segments"),
}


@pytest.mark.parametrize("route", list(KERNEL_ROUTES))
def test_spmd_axes_outside_a_mesh_keeps_the_kernel_route(route, monkeypatch):
    """Outside a mesh ``spmd_axes`` leaves a ``fused="kernel"`` strategy on
    its kernel's route (on the CPU the kernel's plain version), one call a
    round, and the round bitwise the round without it; only a round on a
    mesh contracts in plain ops."""
    from repro_torch.core import flatten
    from repro_torch.kernels import ops

    name, segment_d, entry = KERNEL_ROUTES[route]
    loss_fn, init, clients, copt, sopt = _task()
    batches = {k: torch.as_tensor(v) for k, v in clients[0].next_batches(2).items()}
    batches = tree.map(lambda x: x[None].expand(N, *x.shape).contiguous(), batches)
    g = torch.Generator().manual_seed(1)
    tau_up = (torch.rand(N, generator=g) < 0.7).float()
    if name == "clustered":
        A = torch.full((2, N // 2, N // 2), 2.0 / N)
        tau_dd = (torch.rand(2, N // 2, N // 2, generator=g) < 0.5).float()
    else:
        A = torch.as_tensor(fedavg_weights(N), dtype=torch.float32)
        tau_dd = (torch.rand(N, N, generator=g) < 0.5).float()
    calls = []
    real = getattr(ops, entry)
    monkeypatch.setattr(ops, entry, lambda *a, **k: calls.append(1) or real(*a, **k))
    outs = []
    for axes in (None, ("data",)):
        strategy = strategies.get(name, fused="kernel")
        rc = RoundConfig(n_clients=N, local_steps=2, aggregation=strategy, segment_d=segment_d,
                         spmd_axes=axes)
        state = strategy.init_state(N, flatten.flat_spec(init).d)
        fn = make_round_fn(loss_fn, copt, sopt, rc)
        outs.append(fn(init, sopt.init(init), state, batches, tau_up, tau_dd, A))
        assert len(calls) == 1, f"{entry} called {len(calls)} times a round"
        calls.clear()
    (p0, s0, a0, m0), (p1, s1, a1, m1) = outs
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p0) + tree.leaves(s0),
                                                 tree.leaves(p1) + tree.leaves(s1)))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(a0), tree.leaves(a1))
               if isinstance(a, torch.Tensor) and a.is_floating_point())
    assert m0.keys() == m1.keys()
    assert all(np.array_equal(m0[k].numpy(), m1[k].numpy(), equal_nan=True) for k in m0)


def _run(**kw):
    loss_fn, init, clients, copt, sopt = _task()
    model = topology.paper_fig2b()
    A = np.full((N, N), 1.0 / N) + np.eye(N) * 0.1
    tr = FLTrainer(loss_fn, init, model, A, clients, copt, sopt, local_steps=2, seed=0,
                   device="cpu", **kw)
    tr.run(ROUNDS)
    return tr


SPELLINGS = {
    "enum_colrel_fused": ({"aggregation": Aggregation.COLREL_FUSED}, "collapse", FUSED_MSG),
    "alias_colrel_fused": ({"strategy": "colrel_fused"}, "collapse", FUSED_MSG),
    "aggregation_alias": ({"aggregation": "colrel_fused"}, "collapse", FUSED_MSG),
    "use_fused_kernel": ({"use_fused_kernel": True}, "kernel", KERNEL_MSG),
    "aggregation_use_fused_kernel": ({"aggregation": Aggregation.COLREL,
                                      "use_fused_kernel": True}, "kernel", KERNEL_MSG),
    "aggregation_colrel": ({"aggregation": Aggregation.COLREL}, False, None),
}


@pytest.mark.parametrize("name", sorted(SPELLINGS))
def test_trainer_spelling_runs_colrels_round(name):
    kw, fused, message = SPELLINGS[name]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always", DeprecationWarning)
        got = _run(**kw)
    messages = [str(w.message) for w in rec if issubclass(w.category, DeprecationWarning)]
    assert messages == ([message] if message else []), messages
    assert got.strategy.name == "colrel" and got.strategy.fused == fused
    want = _run(strategy=strategies.get("colrel", fused=fused))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got.params),
                                                 tree.leaves(want.params)))
    for key in ("loss", "participation", "uplink_bits", "weight_sums"):
        np.testing.assert_array_equal(getattr(got.log, key), getattr(want.log, key), key)


def test_trainer_refuses_both_strategy_and_aggregation():
    loss_fn, init, clients, copt, sopt = _task()
    with pytest.raises(ValueError, match="pass strategy= or aggregation=, not both"):
        FLTrainer(loss_fn, init, topology.paper_fig2b(), fedavg_weights(N), clients, copt, sopt,
                  strategy="colrel", aggregation="colrel", device="cpu")
    with pytest.raises(ValueError, match="only applies to the colrel strategy"):
        FLTrainer(loss_fn, init, topology.paper_fig2b(), fedavg_weights(N), clients, copt, sopt,
                  aggregation=Aggregation.FEDAVG_BLIND, use_fused_kernel=True, device="cpu")

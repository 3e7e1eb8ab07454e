"""Declarative experiment assembly: one spec -> a ready-to-run trainer.

The counterpart of ``repro.fl.experiment``.  :class:`ExperimentSpec`
names each choice once and :func:`build_experiment` picks the topology,
wraps it in the channel, optimizes or defaults the relay weights,
partitions the data, builds the model and optimizers, and hands them to
:class:`~repro_torch.fl.trainer.FLTrainer`::

    spec = ExperimentSpec(model="cifar_cnn_full", strategy="colrel",
                          strategy_options={"fused": "kernel"})
    exp = build_experiment(spec)          # on the CUDA device
    exp.run(3)

Model kinds: ``cifar_cnn`` / ``cifar_cnn_full`` (the paper's CIFAR-10
experiment on synthetic CIFAR, reduced or paper-width ResNet-20) and
``quadratic`` (the strongly-convex theory-check task).  The same spec and
seed give the same data, batches, taus and relay weights as the
reference; model init differs (another RNG), so a comparison feeds the
reference's init params through :func:`repro_torch.convert.params_from_jax`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import strategies as strategy_registry
from repro_torch.configs import colrel_paper
from repro_torch.configs.channels import CHANNEL_PRESETS, make_channel
from repro_torch.core import topology
from repro_torch.core.connectivity import LinkModel
from repro_torch.core.weights import (
    OptResult,
    fedavg_weights,
    importance_weights,
    optimize_weights,
)
from repro_torch.data.partition import partition_iid, partition_sort_and_partition
from repro_torch.data.pipeline import ClientDataset, make_federated_clients
from repro_torch.data.synthetic import quadratic_problem, synthetic_cifar
from repro_torch.fl.round import check_mode
from repro_torch.fl.trainer import FLTrainer, TrainLog, resolve_device, unported
from repro_torch.models import cnn
from repro_torch.optim import sgd, sgd_momentum

__all__ = ["TOPOLOGIES", "ExperimentSpec", "Experiment", "build_experiment"]

# Named topology factories (the paper's figures + synthetic layouts).
TOPOLOGIES: Dict[str, Callable[[], LinkModel]] = {
    "fig2a": lambda: topology.paper_fig2a(),
    "fig2b": lambda: topology.paper_fig2b(),
    "mmwave_int": lambda: topology.paper_mmwave_layout(d2d_mode="intermittent"),
    "mmwave_perm": lambda: topology.paper_mmwave_layout(d2d_mode="permanent"),
    "no_collab": lambda: topology.no_collaboration(10, 0.3),
}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything that defines one federated experiment; the fields and
    defaults are the reference's.  Fields whose feature is not ported yet
    raise ``NotImplementedError`` in :func:`build_experiment` when set.

    Task: ``model`` (``"cifar_cnn"``, ``"cifar_cnn_full"``,
    ``"quadratic"``), ``topology`` (a key of :data:`TOPOLOGIES` or a
    :class:`LinkModel`), ``non_iid_s`` (0 = IID, else sort-and-partition
    shards per client), ``data_size`` / ``eval_size``.

    Protocol: ``strategy`` + ``strategy_options`` (a registry name and
    its constructor kwargs, e.g. ``{"fused": "kernel"}``), ``alpha``
    (``"auto"``, ``"copt"``, ``"fedavg"``, ``"importance"`` or an
    ``(n, n)`` array), ``copt_sweeps``, ``mode``, ``local_steps`` (the
    paper's T), ``rounds``, ``chunk``, ``segment_d`` (flat-dim threshold
    for segment-streaming aggregation; 0 = monolithic).

    Channel: ``channel`` (a preset of
    :data:`repro_torch.configs.channels.CHANNEL_PRESETS`: ``static``,
    ``markov_iid``, ``markov``, ``markov_heavy``), ``adaptive``.

    Optimization (None = model-kind / paper defaults): ``lr``,
    ``weight_decay``, ``server_momentum``, ``batch_size``, ``seed``.

    Observability and checkpointing: ``telemetry``, ``metrics_dir``,
    ``profile_dir``, ``ckpt_dir``, ``ckpt_every``, ``ckpt_keep``,
    ``resume_from``.
    """

    # -- task ----------------------------------------------------------
    model: str = "cifar_cnn"  # cifar_cnn | cifar_cnn_full | quadratic
    topology: Union[str, LinkModel] = "fig2b"
    non_iid_s: int = 0
    data_size: int = 10000
    eval_size: int = 2000
    # -- protocol ------------------------------------------------------
    strategy: Union[str, strategy_registry.AggregationStrategy] = "colrel"
    strategy_options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    alpha: Union[str, np.ndarray] = "auto"
    copt_sweeps: int = 30
    mode: str = "per_client"
    local_steps: Optional[int] = None
    rounds: int = 200
    chunk: int = 1
    segment_d: int = 0
    # -- channel -------------------------------------------------------
    channel: str = "static"
    adaptive: bool = False
    # -- optimization --------------------------------------------------
    lr: Optional[float] = None
    weight_decay: Optional[float] = None
    server_momentum: Optional[float] = None
    batch_size: Optional[int] = None
    seed: int = 0
    # -- observability and checkpointing -------------------------------
    telemetry: bool = False
    metrics_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    ckpt_keep: int = 3
    resume_from: Optional[str] = None

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Experiment:
    """A built experiment: the trainer plus the assembly provenance."""

    spec: ExperimentSpec
    trainer: FLTrainer
    link_model: LinkModel
    A: np.ndarray
    strategy: strategy_registry.AggregationStrategy
    copt_result: Optional[OptResult] = None

    @property
    def log(self) -> TrainLog:
        return self.trainer.log

    @property
    def params(self):
        return self.trainer.params

    def run(self, rounds: Optional[int] = None, *, eval_every: int = 0,
            verbose: bool = False) -> TrainLog:
        return self.trainer.run(rounds if rounds is not None else self.spec.rounds,
                                eval_every=eval_every, verbose=verbose)


def _check_ported(spec: ExperimentSpec) -> None:
    check_mode(spec.mode)
    if spec.chunk > 1:
        raise unported(f"chunk={spec.chunk} (the chunked multi-round engine)",
                       "item 8 (chunked engine)")
    preset = CHANNEL_PRESETS.get(spec.channel)
    if preset is not None and preset.kind == "mobility":
        raise unported(f"channel {spec.channel!r}", "item 9 (channels: mobility)")
    if spec.adaptive:
        raise unported("adaptive alpha re-optimization", "item 21 (adaptive alpha)")
    if spec.telemetry or spec.metrics_dir is not None or spec.profile_dir is not None:
        raise unported("telemetry (telemetry, metrics_dir, profile_dir)", "item 14 (telemetry)")
    if (spec.ckpt_dir is not None or spec.resume_from is not None
            or spec.ckpt_every != 0 or spec.ckpt_keep != 3):
        raise unported("checkpointing (ckpt_*, resume_from)", "item 15 (checkpointing)")


def _resolve_topology(spec: ExperimentSpec) -> LinkModel:
    if isinstance(spec.topology, LinkModel):
        return spec.topology
    try:
        return TOPOLOGIES[spec.topology]()
    except KeyError:
        raise KeyError(
            f"unknown topology {spec.topology!r}; have {sorted(TOPOLOGIES)}") from None


def _resolve_alpha(spec: ExperimentSpec, model: LinkModel, strategy):
    alpha = spec.alpha
    if isinstance(alpha, str):
        if alpha == "auto":
            alpha = "copt" if strategy.needs_A else "fedavg"
        if alpha == "copt":
            res = optimize_weights(model, sweeps=spec.copt_sweeps,
                                   fine_tune_sweeps=spec.copt_sweeps)
            return res.A, res
        if alpha == "fedavg":
            return fedavg_weights(model.n), None
        if alpha == "importance":
            return importance_weights(model), None
        raise ValueError(f"unknown alpha spec {alpha!r}")
    return np.asarray(alpha, np.float64), None


def _build_cifar(spec: ExperimentSpec, n: int, device: torch.device):
    setup = colrel_paper.full() if spec.model == "cifar_cnn_full" else colrel_paper.reduced()
    batch_size = setup.batch_size if spec.batch_size is None else spec.batch_size
    images, labels = synthetic_cifar(n=spec.data_size, seed=spec.seed + 1)
    ev_img, ev_lab = synthetic_cifar(n=spec.eval_size, seed=spec.seed + 2)
    if spec.non_iid_s:
        parts = partition_sort_and_partition(labels, n, s=spec.non_iid_s, seed=spec.seed)
    else:
        parts = partition_iid(len(labels), n, seed=spec.seed)
    clients = make_federated_clients({"images": images, "labels": labels},
                                     parts, batch_size, seed=spec.seed)
    model = cnn.CNN(setup.cnn, generator=torch.Generator().manual_seed(spec.seed)).to(device)

    def loss_fn(params, batch):
        return cnn.loss_fn(model, params, batch)

    ev_batch = {"images": torch.as_tensor(ev_img, device=device),
                "labels": torch.as_tensor(ev_lab, device=device)}

    @torch.no_grad()
    def eval_fn(params):
        _, m = loss_fn(params, ev_batch)
        return {k: float(v) for k, v in m.items()}

    return (
        loss_fn,
        model.param_tree(),
        clients,
        sgd(setup.lr if spec.lr is None else spec.lr,
            weight_decay=setup.weight_decay if spec.weight_decay is None
            else spec.weight_decay),
        sgd_momentum(1.0, beta=setup.server_momentum
                     if spec.server_momentum is None else spec.server_momentum),
        setup.local_steps if spec.local_steps is None else spec.local_steps,
        eval_fn,
    )


def _build_quadratic(spec: ExperimentSpec, n: int, device: torch.device):
    """Strongly-convex heterogeneous quadratic (the theory-check task)."""
    dim = 16
    prob = quadratic_problem(n, dim, mu=1.0, L=8.0, hetero=1.0, seed=spec.seed)
    H = torch.as_tensor(prob["H"], dtype=torch.float32, device=device)
    x_star = torch.as_tensor(prob["x_star"], dtype=torch.float32, device=device)

    def loss_fn(params, batch):
        x = params["x"]
        d = x - batch["center"][0]
        return 0.5 * d @ (H @ d) + 0.3 * batch["noise"][0] @ x, {}

    clients = []
    for i in range(n):
        c = prob["centers"][i].astype(np.float32)
        pool = np.random.default_rng(50 + i).normal(size=(2048, dim)).astype(np.float32)
        clients.append(ClientDataset(
            {"center": np.tile(c, (2048, 1)), "noise": pool},
            batch_size=1 if spec.batch_size is None else spec.batch_size,
            seed=spec.seed + i))

    def eval_fn(params):
        return {"dist2": float(torch.sum((params["x"] - x_star) ** 2))}

    return (
        loss_fn,
        {"x": torch.zeros(dim, dtype=torch.float32, device=device)},
        clients,
        sgd(spec.lr if spec.lr is not None else 0.02),
        sgd_momentum(1.0, beta=spec.server_momentum
                     if spec.server_momentum is not None else 0.0),
        2 if spec.local_steps is None else spec.local_steps,
        eval_fn,
    )


_MODEL_BUILDERS = {
    "cifar_cnn": _build_cifar,
    "cifar_cnn_full": _build_cifar,
    "quadratic": _build_quadratic,
}


def build_experiment(spec: ExperimentSpec, device=None) -> Experiment:
    """Assemble model, data, topology, channel, strategy and optimizers
    from one spec, on ``device`` (the CUDA device unless given)."""
    if spec.model not in _MODEL_BUILDERS:
        raise KeyError(f"unknown model kind {spec.model!r}; have {sorted(_MODEL_BUILDERS)}")
    _check_ported(spec)
    dev = resolve_device(device)
    link_model = _resolve_topology(spec)
    channel = make_channel(spec.channel, link_model, seed=spec.seed)
    n = link_model.n
    strategy = strategy_registry.resolve(spec.strategy, **dict(spec.strategy_options))
    A, copt_result = _resolve_alpha(spec, link_model, strategy)
    loss_fn, init_params, clients, client_opt, server_opt, local_steps, eval_fn = (
        _MODEL_BUILDERS[spec.model](spec, n, dev))
    trainer = FLTrainer(
        loss_fn, init_params, link_model, A, clients, client_opt, server_opt,
        local_steps=local_steps, strategy=strategy, mode=spec.mode,
        segment_d=spec.segment_d, seed=spec.seed, eval_fn=eval_fn,
        channel=channel, device=dev,
    )
    return Experiment(spec=spec, trainer=trainer, link_model=link_model,
                      A=np.asarray(A), strategy=strategy, copt_result=copt_result)

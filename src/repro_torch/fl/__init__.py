"""Federated runtime: the round, the trainer and the declarative
:class:`~repro_torch.fl.experiment.ExperimentSpec`."""

from .round import RoundConfig, make_round_fn, make_scan_round_fn
from .trainer import FLTrainer, TrainLog
from .experiment import Experiment, ExperimentSpec, TOPOLOGIES, build_experiment

__all__ = [
    "RoundConfig",
    "make_round_fn",
    "make_scan_round_fn",
    "FLTrainer",
    "TrainLog",
    "Experiment",
    "ExperimentSpec",
    "TOPOLOGIES",
    "build_experiment",
]

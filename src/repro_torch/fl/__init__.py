"""Federated runtime: the round, the trainer and the declarative
:class:`~repro_torch.fl.experiment.ExperimentSpec`."""

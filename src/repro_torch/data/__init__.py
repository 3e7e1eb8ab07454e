"""Datasets, partitions and per-client batch streams (numpy copies of
``repro.data``: the same seed gives the same data and batches)."""

from .synthetic import synthetic_cifar, synthetic_tokens, quadratic_problem
from .partition import partition_iid, partition_sort_and_partition
from .pipeline import ClientDataset, federated_batches, make_federated_clients

__all__ = [
    "synthetic_cifar",
    "synthetic_tokens",
    "quadratic_problem",
    "partition_iid",
    "partition_sort_and_partition",
    "ClientDataset",
    "federated_batches",
    "make_federated_clients",
]

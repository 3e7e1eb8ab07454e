"""Federated dataset partitioning: IID and the paper's sort-and-partition
non-IID scheme (skew parameter ``s`` = max distinct labels per client).
A numpy copy of ``repro.data.partition``."""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["partition_iid", "partition_sort_and_partition"]


def partition_iid(n_samples: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]


def partition_sort_and_partition(
    labels: np.ndarray, n_clients: int, s: int, seed: int = 0
) -> List[np.ndarray]:
    """Sort by label, split into ``n_clients * s`` shards, deal ``s`` shards
    to each client at random (the paper's Sec. V scheme).  Each client ends
    up with samples from at most ``s`` distinct labels."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_clients * s)
    shard_ids = rng.permutation(n_clients * s)
    out = []
    for c in range(n_clients):
        take = shard_ids[c * s : (c + 1) * s]
        out.append(np.sort(np.concatenate([shards[t] for t in take])))
    return out

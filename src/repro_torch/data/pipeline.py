"""Per-client batch streams for the FL trainer.

A numpy copy of ``repro.data.pipeline``: the same seed gives the same
batches in both packages.

``ClientDataset`` wraps one client's local arrays and yields minibatches
with its own RNG (clients sample independently, as in local SGD).
``federated_batches`` stacks one minibatch per client into a leading
client axis, ``(n_clients, B, ...)``.  ``stack_chunk_batches`` gathers K rounds of T local steps for every
client in one vectorized fancy-index per client, laid out
``(K, n, T, B, ...)``; the per-round trainer takes ``K = 1``.

Bulk draws are *stream-equivalent* to repeated single draws: numpy's
``Generator.integers`` fills a ``(m, B)`` request with exactly the
values ``m`` successive ``(B,)`` requests would produce, so a trainer
consuming the stream in chunks of any size sees bitwise-identical
batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["ClientDataset", "federated_batches", "make_federated_clients",
           "stack_chunk_batches"]


@dataclasses.dataclass
class ClientDataset:
    arrays: Dict[str, np.ndarray]  # same leading dim N_i
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        ns = {k: v.shape[0] for k, v in self.arrays.items()}
        if len(set(ns.values())) != 1:
            raise ValueError(f"ragged arrays {ns}")
        self.n = next(iter(ns.values()))
        self._rng = np.random.default_rng(self.seed)

    def next_batch(self) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.n, size=self.batch_size)
        return {k: v[idx] for k, v in self.arrays.items()}

    def next_batches(self, m: int) -> Dict[str, np.ndarray]:
        """``m`` successive minibatches in one vectorized gather: leaves
        ``(m, B, ...)``, the same RNG stream as ``m`` draws of one batch."""
        idx = self._rng.integers(0, self.n, size=(m, self.batch_size))
        return {k: v[idx] for k, v in self.arrays.items()}


def federated_batches(clients: Sequence[ClientDataset]) -> Dict[str, np.ndarray]:
    """One synchronized round of minibatches, stacked (n_clients, B, ...)."""
    batches = [c.next_batch() for c in clients]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def stack_chunk_batches(
    clients: Sequence[ClientDataset], local_steps: int, rounds: int = 1
) -> Dict[str, np.ndarray]:
    """``rounds`` synchronized rounds of ``local_steps`` minibatches per
    client, stacked ``(rounds, n_clients, T, B, ...)``.

    One ``rounds * T``-deep gather per client replaces the old nested
    per-round / per-step python loops; with ``rounds=1`` this is exactly
    the per-round trainer layout (squeeze the leading axis).
    """
    m = rounds * local_steps
    per_client = [c.next_batches(m) for c in clients]

    def stack(key: str) -> np.ndarray:
        return np.stack(
            [pc[key].reshape(rounds, local_steps, *pc[key].shape[1:])
             for pc in per_client],
            axis=1,
        )

    return {k: stack(k) for k in per_client[0]}


def make_federated_clients(
    arrays: Dict[str, np.ndarray],
    partitions: List[np.ndarray],
    batch_size: int,
    seed: int = 0,
) -> List[ClientDataset]:
    return [
        ClientDataset({k: v[idx] for k, v in arrays.items()}, batch_size, seed=seed + 997 * i)
        for i, idx in enumerate(partitions)
    ]

"""The clients' data as the benchmark hands it to both sides: each client's
shard, and the stream of minibatches drawn from it.

A shard is a dict of host arrays with one leading sample axis.  A
:class:`ShardStream` draws its minibatch indices from a numpy generator
seeded by the run's seed and the client's index, so a fresh stream of the
same seed gives the reference the batches the program was given.  It
serves the program's trainer through ``next_batches(m)``, the call the
trainer's batch stacking makes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["ShardStream", "streams", "sort_and_partition"]


class ShardStream:
    """One client's shard and its minibatch stream."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, seed: int, client: int):
        sizes = {v.shape[0] for v in arrays.values()}
        if len(sizes) != 1:
            raise ValueError(f"ragged shard: {sorted(sizes)}")
        self.arrays = arrays
        self.batch_size = int(batch_size)
        self.n = sizes.pop()
        self._rng = np.random.default_rng([int(seed), 0xda7a, int(client)])

    def next_batches(self, m: int) -> Dict[str, np.ndarray]:
        """``m`` minibatches, leaves ``(m, B, ...)``."""
        idx = self._rng.integers(0, self.n, size=(m, self.batch_size))
        return {k: v[idx] for k, v in self.arrays.items()}


def streams(shards: List[Dict[str, np.ndarray]], batch_size: int, seed: int) -> List[ShardStream]:
    return [ShardStream(s, batch_size, seed, i) for i, s in enumerate(shards)]


def sort_and_partition(labels: np.ndarray, n_clients: int, s: int,
                       rng: np.random.Generator) -> List[np.ndarray]:
    """The paper's non-IID split (Sec. V): the samples sorted by label, cut
    into ``n_clients * s`` shards, ``s`` shards dealt to each client at
    random, so that a client holds at most ``s`` labels."""
    order = np.argsort(labels, kind="stable")
    pieces = np.array_split(order, n_clients * s)
    deal = rng.permutation(n_clients * s)
    return [np.sort(np.concatenate([pieces[t] for t in deal[c * s:(c + 1) * s]]))
            for c in range(n_clients)]

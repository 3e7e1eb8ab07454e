"""Per-round connectivity service: the paper's i.i.d. channel.

A numpy copy of the host side of ``repro.channel.base``.  The trainer
asks a channel for

* ``tau_for_round(r)`` — the round-r realization ``(tau_up (n,),
  tau_dd (n, n))``, same conventions as
  :func:`repro_torch.core.connectivity.sample_round`;
* ``trace(start, rounds)`` — the same stream in bulk, ``(K, n)`` and
  ``(K, n, n)`` for rounds ``[start, start + K)``;
* ``model_for_round(r)`` — the ground-truth marginals as a
  :class:`LinkModel`.

:class:`StaticChannel` draws with numpy exactly as the reference does, so
the same seed gives the same taus in both packages.  Rounds are consumed
in nondecreasing order; the stream cannot rewind past its current block.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.connectivity import LinkModel, sample_rounds

__all__ = ["BlockBufferedChannel", "StaticChannel"]


class BlockBufferedChannel:
    """Serve a per-round tau stream out of block-generated trace buffers.

    Subclasses implement ``_generate_block(rounds) -> (ups, dds)`` with
    shapes ``(R, n)`` / ``(R, n, n)``; per-round and bulk service read
    the same buffers, so both see bitwise-identical streams.
    """

    def __init__(self, n: int, block: int = 256):
        if block <= 0:
            raise ValueError("block must be positive")
        self._n = int(n)
        self.block = int(block)
        self._buf_start = 0  # first round of the current buffer
        self._ups = None
        self._dds = None

    @property
    def n(self) -> int:
        return self._n

    def _generate_block(self, rounds: int):
        raise NotImplementedError

    def _ensure(self, r: int) -> None:
        if r < self._buf_start:
            raise ValueError(
                f"{type(self).__name__} cannot rewind to round {r} "
                f"(buffer starts at {self._buf_start})"
            )
        while self._ups is None or r >= self._buf_start + self._ups.shape[0]:
            if self._ups is not None:
                self._buf_start += self._ups.shape[0]
            ups, dds = self._generate_block(self.block)
            self._ups = np.asarray(ups, np.float64)
            self._dds = np.asarray(dds, np.float64)

    def tau_for_round(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        self._ensure(r)
        i = r - self._buf_start
        return self._ups[i], self._dds[i]

    def trace(self, start: int, rounds: int) -> tuple[np.ndarray, np.ndarray]:
        """Bulk service of rounds ``[start, start + rounds)``, concatenated
        across block refills."""
        parts_u, parts_d = [], []
        r = start
        while r < start + rounds:
            self._ensure(r)
            i = r - self._buf_start
            j = min(start + rounds - self._buf_start, self._ups.shape[0])
            parts_u.append(self._ups[i:j])
            parts_d.append(self._dds[i:j])
            r = self._buf_start + j
        return np.concatenate(parts_u), np.concatenate(parts_d)


class StaticChannel(BlockBufferedChannel):
    """The paper's i.i.d. channel: rounds are pre-generated ``block`` at a
    time through the vectorized :func:`sample_rounds`."""

    def __init__(self, model: LinkModel, seed: int = 0, block: int = 256):
        super().__init__(model.n, block)
        self.model = model
        self._rng = np.random.default_rng(seed)

    def _generate_block(self, rounds: int):
        return sample_rounds(self.model, self._rng, rounds)

    def model_for_round(self, r: int) -> LinkModel:
        return self.model

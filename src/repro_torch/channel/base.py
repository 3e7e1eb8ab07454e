"""Per-round connectivity service: the :class:`ChannelProcess` protocol
and the paper's i.i.d. channel.

A numpy copy of the host side of ``repro.channel.base``.  The trainer
asks a channel for

* ``tau_for_round(r)`` — the round-r realization ``(tau_up (n,),
  tau_dd (n, n))``, same conventions as
  :func:`repro_torch.core.connectivity.sample_round`, or ``tau_dd`` as
  ``(C, m, m)`` blocks for the clustered channels;
* ``trace(start, rounds)`` — the same stream in bulk, ``(K, n)`` and
  ``(K, n, n)`` (or ``(K, C, m, m)``) for rounds ``[start, start + K)``;
* ``model_for_round(r)`` — the ground-truth marginals as a
  :class:`LinkModel` (or :class:`ClusteredLinkModel`);
* ``scan_sampler(device)`` — ``(init_fn, sample_fn)`` drawing rounds of
  the same law on ``device`` inside the chunked engine's captured round
  (``run(..., no_trace=True)``): ``init_fn(gen)`` gives the carried state
  and ``sample_fn(state, gen) -> (tau_up, tau_dd, state)`` draws one
  round from the explicit ``torch.Generator`` ``gen``.

:class:`StaticChannel` draws with numpy exactly as the reference does, so
the same seed gives the same taus in both packages.  Rounds are consumed
in nondecreasing order; the stream cannot rewind past its current block.
The in-scan samplers draw from a ``torch.Generator``, not numpy, so they
agree with the traced stream (and with the reference's samplers, which
draw from ``jax.random``) in law, not draw for draw.

``checkpoint_state()`` / ``restore_state(state)`` save and reinstate a
channel's position in its stream: for a block-buffered channel the
generator state from before its current block, so a restore regenerates
that block bitwise.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.ckpt.schema import rng_from_json, rng_state_to_json
from repro_torch.core.connectivity import LinkModel, sample_rounds

__all__ = ["ChannelProcess", "BlockBufferedChannel", "StaticChannel", "pair_lane_table",
           "stacked_trace", "static_scan_sampler"]


@runtime_checkable
class ChannelProcess(Protocol):
    """Anything that can serve per-round connectivity realizations."""

    @property
    def n(self) -> int: ...

    def tau_for_round(self, r: int) -> tuple[np.ndarray, np.ndarray]: ...

    def trace(self, start: int, rounds: int): ...

    def model_for_round(self, r: int) -> LinkModel: ...


def stacked_trace(channel, start: int, rounds: int):
    """The ``trace`` of a channel with per-round host state (mobility's
    geometry advances every round): ``tau_for_round`` for each round,
    stacked — the same stream, in bulk layout, at the per-round cost."""
    ups, dds = zip(*(channel.tau_for_round(start + i) for i in range(rounds)))
    return np.stack(ups), np.stack(dds)


class BlockBufferedChannel:
    """Serve a per-round tau stream out of block-generated trace buffers.

    Subclasses implement ``_generate_block(rounds) -> (ups, dds)`` with
    shapes ``(R, n)`` / ``(R, n, n)`` (or ``(R, C, m, m)``); per-round and
    bulk service read the same buffers, so both see bitwise-identical
    streams.  Subclasses draw from one numpy ``Generator``, ``self._rng``;
    the Gilbert–Elliott ones also carry their packed gate state,
    ``self._gates``, across blocks.  Those two are the generator state
    whose capture just before ``_generate_block`` makes that block's
    regeneration deterministic (``_gen_state`` / ``_set_gen_state``).
    """

    def __init__(self, n: int, block: int = 256):
        if block <= 0:
            raise ValueError("block must be positive")
        self._n = int(n)
        self.block = int(block)
        self._buf_start = 0  # first round of the current buffer
        self._ups = None
        self._dds = None
        # generator state from before the current buffer's generation
        self._pre_block = None

    @property
    def n(self) -> int:
        return self._n

    def _generate_block(self, rounds: int):
        raise NotImplementedError

    def _gen_state(self) -> dict:
        gates = getattr(self, "_gates", None)
        return {"rng": rng_state_to_json(self._rng),
                "gates": None if gates is None else np.array(gates)}

    def _set_gen_state(self, state: dict) -> None:
        self._rng = rng_from_json(state["rng"])
        if state["gates"] is not None:
            self._gates = np.asarray(state["gates"], bool)

    def _advance_block(self) -> None:
        if self._ups is not None:
            self._buf_start += self._ups.shape[0]
        self._pre_block = self._gen_state()
        ups, dds = self._generate_block(self.block)
        self._ups = np.asarray(ups, np.float64)
        self._dds = np.asarray(dds, np.float64)

    def _ensure(self, r: int) -> None:
        if r < self._buf_start:
            raise ValueError(
                f"{type(self).__name__} cannot rewind to round {r} "
                f"(buffer starts at {self._buf_start})"
            )
        while self._ups is None or r >= self._buf_start + self._ups.shape[0]:
            self._advance_block()

    def checkpoint_state(self) -> dict:
        """The stream position and generator state: rather than the tau
        buffers, the generator state from before the current block and the
        block's first round; a restore reinstates that state and drops the
        buffers, so the next service regenerates the same block."""
        gen = self._gen_state() if self._ups is None else self._pre_block
        return {"kind": type(self).__name__, "block": self.block,
                "buf_start": int(self._buf_start), "gen": gen}

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`checkpoint_state` on a channel of the same kind
        and block size."""
        if state.get("kind") != type(self).__name__:
            raise ValueError(f"checkpoint is for channel {state.get('kind')!r}; this "
                             f"is a {type(self).__name__}")
        if int(state["block"]) != self.block:
            raise ValueError(f"checkpointed block size {state['block']} != {self.block} "
                             "(the block size shapes the RNG stream)")
        self._set_gen_state(state["gen"])
        self._buf_start = int(state["buf_start"])
        self._ups = self._dds = self._pre_block = None

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

    def scan_sampler(self, device):
        """``(init_fn, sample_fn)`` drawing i.i.d. rounds in-scan on ``device``."""
        return static_scan_sampler(self.model, device)


def pair_lane_table(n: int) -> np.ndarray:
    """``(n*n,)`` gather lanes for assembling ``tau_dd`` from per-pair
    draws: entry ``(i, j)`` picks its unordered pair's tau_ij lane (upper
    triangle), tau_ji lane (lower triangle, offset by ``m``), or the
    constant-1 diagonal lane ``2m``, where ``m = n(n-1)/2`` — the layout of
    the stacked ``[tij, tji, ones]`` form."""
    iu, ju = np.triu_indices(n, k=1)
    m = iu.shape[0]
    lane = np.full((n, n), 2 * m, np.int32)
    lane[iu, ju] = np.arange(m)
    lane[ju, iu] = m + np.arange(m)
    return lane.ravel()


def gather_pairs(tij: torch.Tensor, tji: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """``(..., m*m)`` bool from per-pair draws ``tij``/``tji`` ``(..., mp)``
    through :func:`pair_lane_table` lanes ``lane``: the stacked
    ``[tij, tji, ones]`` form gathered along the last axis."""
    ones = torch.ones((*tij.shape[:-1], 1), dtype=torch.bool, device=tij.device)
    return torch.index_select(torch.cat([tij, tji, ones], dim=-1), -1, lane)


def static_scan_sampler(model: LinkModel, device):
    """In-scan sampler for the paper's i.i.d. law on ``device``:
    ``(init_fn, sample_fn)``.

    ``sample_fn(state, gen)`` draws one round's ``(tau_up, tau_dd)`` from
    ``gen`` with the same one-uniform-per-pair reciprocity coupling as
    :func:`repro_torch.core.connectivity.sample_round`, in tensor ops that
    a CUDA graph captures.  The process is i.i.d., so the carried state is
    ``()``.
    """
    n = model.n
    iu, ju = np.triu_indices(n, k=1)
    m = iu.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.as_tensor(model.p, **f32)
    pij = torch.as_tensor(model.P[iu, ju], **f32)
    pji = torch.as_tensor(model.P[ju, iu], **f32)
    e = torch.as_tensor(model.E[iu, ju], **f32)
    lane = torch.as_tensor(pair_lane_table(n), dtype=torch.int64, device=device)

    def init_fn(gen):
        del gen
        return ()

    def sample_fn(state, gen):
        tau_up = (torch.rand(n, generator=gen, **f32) < p).float()
        uu = torch.rand(m, generator=gen, **f32)
        both = uu < e
        tij = both | ((uu >= e) & (uu < pij))
        tji = both | ((uu >= pij) & (uu < pij + pji - e))
        return tau_up, gather_pairs(tij, tji, lane).reshape(n, n).float(), state

    return init_fn, sample_fn

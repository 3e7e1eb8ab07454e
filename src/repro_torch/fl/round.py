"""One federated round on tensors (Algorithms 1 + 2 of the paper).

1. every client runs ``T`` local SGD steps from the PS model (Alg. 1, 1-7);
2. clients exchange updates over the sampled D2D links and each transmits
   a weighted consensus to the PS (Alg. 1, 8-11 / Eq. (3));
3. the PS applies the round's aggregation strategy and the server
   optimizer (global momentum in the paper's experiments).

Execution modes, as the reference's:

* ``per_client`` — materializes the per-client update stack; the only
  mode open to stateful or non-collapsible strategies.  The reference
  vmaps over clients; here the clients run in a plain loop and their
  deltas are stacked on a new leading axis.
* ``client_sequential`` — the clients in order, accumulating the
  strategy's scalar collapse ``sum_i w_i delta_i`` over zero f32 leaves:
  one model copy of accumulator, no update stack.
* ``weighted_grad`` — the T = 1 collapse: one backward pass through
  ``sum_i w_i loss_i`` over the clients' ``(n, B, ...)`` batches, then
  one client optimizer step (ColRel as weighted data-parallel SGD).
* ``weighted_flat`` — the same gradient with the client axis folded into
  the batch: each sequence's loss weighted by its client's ``w / B``
  through the loss's ``ce_weight``.

Async relaying (:func:`make_async_round_fn`) is the ``per_client`` round
over an :class:`~repro_torch.strategies.AsyncRelayStrategy`, whose age
vector and staging buffer ride ``agg_state``, with three more metrics.

Multi-round execution: :func:`make_scan_round_fn` runs K rounds of the
same round body per call, the chunked engine ``FLTrainer.run(chunk=K)``
drives.  On the CUDA device the body is captured once as a CUDA graph and
replayed K times, the port's counterpart of the reference's compiled
``lax.scan``.

``telemetry=True`` (in each ``make_*round_fn``) wraps the body with
:func:`repro_torch.telemetry.device.instrument_round_fn`: one more carry,
the ``(n,)`` int32 outage streak, and the per-client vector metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import strategies as strategy_registry
from repro_torch import tree
from repro_torch.core import flatten
from repro_torch.core.aggregation import Aggregation
from repro_torch.kernels import launch_counts
from repro_torch.optim import Optimizer, apply_updates, global_norm
from repro_torch.strategies.base import AggregationStrategy, ExecutionContext
from repro_torch.telemetry.device import instrument_round_fn

Params = Any

StrategySpec = Union[Aggregation, str, AggregationStrategy]

MODES = ("per_client", "client_sequential", "weighted_grad", "weighted_flat")

#: the metrics of every round body, in the order of the chunked engine's
#: ``(K, len(metric_keys))`` device buffer
METRIC_KEYS = ("loss", "delta_norm", "participation", "uplink_bits", "weight_sum")
#: the async round's staleness metrics, after :data:`METRIC_KEYS`
ASYNC_METRIC_KEYS = ("mean_age", "max_age", "stale_frac")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    n_clients: int
    local_steps: int  # the paper's T
    mode: str = "per_client"
    # a registry name, an Aggregation value or a constructed strategy
    aggregation: StrategySpec = "colrel"
    # accepted for the reference's signature and read by nothing in the
    # round, as in the reference, where no line reads it either
    use_flash: bool = False
    # the reference pins the vmapped client axis to these mesh axes; one
    # card has no mesh, so it is accepted and inert
    spmd_axes: Optional[tuple] = None
    # the reference unrolls its local-step and client scans for its dry-run
    # cost probes; the port's loops are eager Python, so it is inert
    unroll: bool = False
    # DEPRECATED: forwards, with a warning, to colrel's fused="kernel"
    use_fused_kernel: bool = False
    # dtype of the flattened (n, d) update stack; accumulation is f32 either way
    flat_dtype: str = "float32"
    # columns each CUDA block of the aggregation kernels covers
    fused_block_d: int = 2048
    # flat-dim threshold for segment-streaming aggregation; 0 = monolithic
    segment_d: int = 0

    def __post_init__(self):
        check_mode(self.mode)
        # fail at construction; canonical_name does not instantiate, so no
        # deprecation warning fires twice
        name = strategy_registry.canonical_name(self.aggregation)
        if self.use_fused_kernel and name != "colrel":
            raise ValueError("use_fused_kernel only applies to the colrel strategy "
                             f"(got {self.aggregation}); it would be silently inert")

    def resolve_strategy(self) -> AggregationStrategy:
        """The configured strategy instance (deprecated spellings warn)."""
        return strategy_registry.resolve(self.aggregation, fused_kernel=self.use_fused_kernel)

    def execution_context(self) -> ExecutionContext:
        return ExecutionContext(
            n_clients=self.n_clients,
            flat_dtype=getattr(torch, self.flat_dtype),
            fused_block_d=self.fused_block_d,
            segment_d=self.segment_d,
        )


def _local_sgd(loss_fn: Callable, client_opt: Optimizer, params: Params,
               batches: Dict[str, torch.Tensor]) -> Tuple[Params, torch.Tensor]:
    """T local SGD steps from ``params``; ``batches`` leaves have leading
    dim T.  Returns the f32 delta ``p_T - p_0`` and the mean step loss."""
    T = next(iter(batches.values())).shape[0]
    p, ostate = params, client_opt.init(params)
    losses = []
    for t in range(T):
        p = tree.map(lambda x: x.detach().requires_grad_(), p)
        leaves, treedef = tree.flatten(p)
        loss, _ = loss_fn(p, {k: v[t] for k, v in batches.items()})
        grads = tree.unflatten(treedef, list(torch.autograd.grad(loss, leaves)))
        upd, ostate = client_opt.update(grads, ostate, p)
        with torch.no_grad():
            p = apply_updates(p, upd)
        losses.append(loss.detach())
    delta = tree.map(lambda a, b: a.detach().float() - b.float(), p, params)
    return delta, torch.mean(torch.stack(losses))


def make_round_fn(loss_fn: Callable, client_opt: Optimizer, server_opt: Optimizer,
                  rc: RoundConfig, telemetry: bool = False):
    """Returns ``round(params, server_state, agg_state, batches, tau_up,
    tau_dd, A) -> (params, server_state, agg_state, metrics)``.

    ``batches``: dict with leaves on the params' device, ``(n_clients, T,
    B, ...)`` for ``per_client`` and ``client_sequential``, ``(n_clients,
    B, ...)`` for ``weighted_grad`` (T = 1 collapsed) and ``(n_clients *
    B, ...)`` for ``weighted_flat``.  ``metrics`` holds 0-d tensors under
    the reference's keys, :data:`METRIC_KEYS`; the returned function
    carries them as its ``metric_keys``.

    Outside ``per_client`` the round consumes only the strategy's scalar
    collapse, so a stateful or non-collapsible strategy raises
    ``ValueError`` here: its state would freeze at ``init_state``.

    ``telemetry=True`` returns the instrumented round, ``round(params,
    server_state, agg_state, batches, tau_up, tau_dd, A, streak) ->
    (params, server_state, agg_state, streak, metrics)``, whose metrics
    add the ``(n,)`` vectors of
    :data:`~repro_torch.telemetry.device.VECTOR_METRICS` and the
    ``weight_drift`` scalar; the body is untouched, so the trajectory and
    the scalar metrics are bitwise those of the plain round.
    """
    strategy = rc.resolve_strategy()
    ctx = rc.execution_context()
    if rc.mode != "per_client" and (strategy.stateful or not strategy.scalar_collapsible):
        raise ValueError(
            f"strategy {strategy.name!r} needs the per_client mode: only it materializes "
            f"the update stack that stateful or non-scalar-collapsible strategies require "
            f"(got mode={rc.mode!r})")

    def weighted_backward(params, weighted_loss):
        """One backward pass through ``weighted_loss(p) -> (total, losses)``
        and one client optimizer step from a fresh state: the f32 delta and
        the losses."""
        p = tree.map(lambda x: x.detach().requires_grad_(), params)
        leaves, treedef = tree.flatten(p)
        total, losses = weighted_loss(p)
        grads = tree.unflatten(treedef, list(torch.autograd.grad(total, leaves)))
        upd, _ = client_opt.update(grads, client_opt.init(params), params)
        return tree.map(lambda u: u.float(), upd), losses.detach()

    def round_fn(params, server_state, agg_state, batches, tau_up, tau_dd, A):
        # realized scalar weights (for ColRel the exact collapse
        # w_j = sum_i tau_i tau_ji alpha_ij / n), logged as weight_sum
        w = strategy.weights(tau_up, tau_dd, A)
        if rc.mode == "per_client":
            # each client's delta goes into its row of the update stack as
            # it is made, so that at most one client's delta is held apart
            # from the stack (stacking a list of them held two stacks)
            stacked, losses = None, []
            for i in range(rc.n_clients):
                delta, loss = _local_sgd(loss_fn, client_opt, params,
                                         {k: v[i] for k, v in batches.items()})
                if stacked is None:
                    stacked = tree.map(lambda d: d.new_empty((rc.n_clients, *d.shape)), delta)
                tree.map(lambda s_, d: s_[i].copy_(d), stacked, delta)
                del delta
                losses.append(loss)
            with torch.no_grad():
                gdelta, agg_state = strategy.aggregate_tree(
                    stacked, tau_up, tau_dd, A, agg_state, ctx)
            mean_loss = torch.mean(torch.stack(losses))
        elif rc.mode == "client_sequential":
            # a running weighted sum over the clients in order, from zero
            # f32 leaves: no update stack
            gdelta = tree.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                    device=x.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=tau_up.device)
            for i in range(rc.n_clients):
                delta, loss = _local_sgd(loss_fn, client_opt, params,
                                         {k: v[i] for k, v in batches.items()})
                with torch.no_grad():
                    gdelta = tree.map(lambda a, d: a + w[i] * d, gdelta, delta)
                loss_sum = loss_sum + loss
            mean_loss = loss_sum / rc.n_clients
        elif rc.mode == "weighted_grad":
            # T = 1: one backward pass over every client's batch with
            # per-client loss weights (the clients in a loop building one
            # graph; the reference vmaps them)
            def weighted_loss(p):
                losses = torch.stack([loss_fn(p, {k: v[i] for k, v in batches.items()})[0]
                                      for i in range(rc.n_clients)])
                return torch.sum(w * losses), losses

            gdelta, losses = weighted_backward(params, weighted_loss)
            mean_loss = torch.mean(losses)
        else:  # weighted_flat
            # the client axis folded into the batch: each sequence weighted
            # by its client's w / B inside the loss (jnp.repeat repeats each
            # element, as repeat_interleave does)
            B_per = next(iter(batches.values())).shape[0] // rc.n_clients
            seq_w = torch.repeat_interleave(w, B_per) / B_per

            def weighted_loss(p):
                loss = loss_fn(p, {**batches, "ce_weight": seq_w})[0]
                return loss, loss

            gdelta, mean_loss = weighted_backward(params, weighted_loss)
        with torch.no_grad():
            # the PS feeds the negative delta to the server optimizer as a
            # pseudo-gradient; with sgd_momentum(1, beta) this is exactly
            # the paper's PS momentum
            pseudo = tree.map(lambda d: -d, gdelta)
            upd, server_state = server_opt.update(pseudo, server_state, params)
            new_params = apply_updates(params, upd)
            participation = torch.sum(tau_up.float())
            d_flat = flatten.flat_spec(params).d
            bits_per_client = float(d_flat * strategy.wire_bits_per_coord(d_flat))
            metrics = {
                "loss": mean_loss,
                "delta_norm": global_norm(gdelta),
                "participation": participation,
                "uplink_bits": participation * bits_per_client,
                # a device-side fill: no host->device copy inside a captured round
                "weight_sum": (torch.sum(w) if w is not None
                               else torch.full((), float("nan"), device=tau_up.device)),
            }
        return new_params, server_state, agg_state, metrics

    round_fn.metric_keys = METRIC_KEYS
    if telemetry:
        return instrument_round_fn(round_fn, strategy.wire_bits_per_coord)
    return round_fn


def make_scan_round_fn(loss_fn: Callable, client_opt: Optimizer, server_opt: Optimizer,
                       rc: RoundConfig, channel_sampler: Optional[Callable] = None,
                       telemetry: bool = False):
    """The chunked multi-round engine: K rounds of :func:`make_round_fn`'s
    body per call, with one host round trip.

    Two signatures, as the reference's ``make_scan_round_fn``:

    * traced (default): ``scan(params, server_state, agg_state, batches,
      tau_up, tau_dd, A) -> (params, server_state, agg_state, metrics)``
      with ``batches`` leaves ``(K, n, T, B, ...)``, ``tau_up (K, n)`` and
      ``tau_dd (K, n, n)`` (or ``(K, C, m, m)``) on the params' device;
    * ``channel_sampler=sample_fn`` (a channel's ``scan_sampler(device)``):
      ``scan(params, server_state, agg_state, batches, channel_state, gen,
      A) -> (params, server_state, agg_state, channel_state, gen,
      metrics)``; each round draws its taus with ``sample_fn(channel_state,
      gen)`` inside the round, so no tau tensor crosses from the host.

    ``metrics`` maps each of the round body's ``metric_keys`` (the five of
    :data:`METRIC_KEYS`, eight for the async round) to a ``(K,)`` device
    tensor.

    ``telemetry=True`` instruments the body (see :func:`make_round_fn`):
    both signatures take one more trailing argument, the ``(n,)`` int32
    streak, and return it before ``metrics`` (after ``gen`` in the sampled
    one); the streak rides the carry and the vector metrics come back
    ``(K, n)``, each from its own device buffer in its own dtype.

    On the CPU the K rounds run as a plain loop over the round body.  On a
    CUDA device one round is captured as a CUDA graph and replayed K times:
    the carry, the chunk's batches and taus, ``A`` and a ``(K, len(metric_keys))``
    metric buffer live in static device buffers, and the body selects round i's
    slot from a device round counter and advances it, so the host does
    nothing between replays.  Capture raises if the round cannot be
    captured; there is no eager fallback on the card.  Generators in the
    carry (the int8 codec's, the sampler's ``gen``) are registered with the
    graph, so replays advance them exactly as eager rounds do and the
    chunk's trajectory is bitwise the per-round loop's.

    The returned carry tensors are the engine's static buffers: the next
    call overwrites them in place (the reference donates its carry;
    ``FLTrainer(donate=False)`` keeps clones instead).  A
    call with the same carry structure, shapes and generators and at most
    the captured K reuses the graph; anything else captures anew.  The
    statistics of the last capture are in ``scan.stats``.
    """
    return ScanRound(make_round_fn(loss_fn, client_opt, server_opt, rc, telemetry=telemetry),
                     channel_sampler)


class ScanRound:
    """The callable :func:`make_scan_round_fn` returns."""

    def __init__(self, round_fn: Callable, sample_fn: Optional[Callable] = None):
        self.round_fn = round_fn
        self.sample_fn = sample_fn
        self._slot: Optional[_RoundSlot] = None
        #: warm-up, capture and instantiate seconds, launches counted in the
        #: warm-up round and in the captured round, the graph's memory pool
        #: bytes, the chunk's static batch and tau buffers' bytes, rounds
        #: replayed since the last capture, and captures made (CUDA only)
        self.stats: Dict[str, Any] = {}

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The captured round (kept, so its nodes can be counted), or None."""
        return self._slot.graph if self._slot is not None else None

    def __call__(self, params, server_state, agg_state, batches, a, b, A, *streak):
        sampled = self.sample_fn is not None
        carry = (params, server_state, agg_state) + ((a,) if sampled else ()) + streak
        xs = dict(batches)
        gen = b if sampled else None
        taus = None if sampled else (a, b)
        K = next(iter(xs.values())).shape[0]
        sig = _signature(carry, xs, taus, A, gen)
        slot = self._slot
        if slot is None or slot.sig != sig or slot.capacity < K:
            self._slot = slot = None  # the old graph and its pool go first
            slot = _RoundSlot(self.round_fn, self.sample_fn, self.stats, carry, xs, taus, A,
                              gen, K, sig)
            self._slot = slot
        out, metrics = slot.run(carry, xs, taus, A, K)
        if sampled:  # the generator goes after the channel state
            return (*out[:4], gen, *out[4:], metrics)
        return (*out, metrics)


def _signature(carry, xs, taus, A, gen):
    def sig(x):
        if isinstance(x, torch.Tensor):
            return ("t", tuple(x.shape), x.dtype, x.device)
        return ("o", id(x))  # generators and other objects by identity

    leaves, treedef = tree.flatten(carry)
    return (treedef, tuple(map(sig, leaves)),
            tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in sorted(xs.items())),
            None if taus is None else tuple(tuple(t.shape[1:]) for t in taus),
            sig(A), None if gen is None else id(gen))


def _load(buf: torch.Tensor, x: torch.Tensor) -> None:
    if buf is not x:
        buf.copy_(x)


class _RoundSlot:
    """Static buffers and the round body for one carry signature, with its
    captured graph on a CUDA device.  It holds no reference back to its
    :class:`ScanRound`, so dropping that frees the graph at once, not at a
    later garbage collection."""

    def __init__(self, round_fn, sample_fn, stats, carry, xs, taus, A, gen, K: int, sig):
        dev = A.device
        self.round_fn, self.sample_fn, self.stats = round_fn, sample_fn, stats
        self.sig, self.capacity, self.gen = sig, K, gen
        leaves, self.treedef = tree.flatten(carry)
        self.bufs = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        self.xs = {k: torch.empty((K, *v.shape[1:]), dtype=v.dtype, device=dev)
                   for k, v in xs.items()}
        self.taus = None if taus is None else tuple(
            torch.empty((K, *t.shape[1:]), dtype=torch.float32, device=dev) for t in taus)
        self.A = A.clone()
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.keys = round_fn.metric_keys
        self.metrics = torch.zeros((K, len(self.keys)), dtype=torch.float32, device=dev)
        # the instrumented round's (n,) vectors, each in its own dtype; the
        # streak, the carry's last leaf, gives n
        self.vectors = {k: torch.zeros((K, leaves[-1].shape[0]), dtype=dt, device=dev)
                        for k, dt in getattr(round_fn, "vector_dtypes", {}).items()}
        self.graph = None
        if dev.type == "cuda":
            self._capture(carry, xs, taus, A, K)

    def body(self) -> None:
        """One round on the static buffers: round ``counter``'s slot in, the
        carry written back in place, the metrics into row ``counter``, and
        ``counter`` advanced.  What the graph captures."""
        i = self.counter
        x = {k: torch.index_select(v, 0, i)[0] for k, v in self.xs.items()}
        # the carry past agg_state: the channel state (sampled), the streak
        # (instrumented)
        params, server_state, agg_state, *rest = tree.unflatten(self.treedef, self.bufs)
        if self.taus is None:
            tau_up, tau_dd, rest[0] = self.sample_fn(rest[0], self.gen)
        else:
            tau_up, tau_dd = (torch.index_select(t, 0, i)[0] for t in self.taus)
        args = (params, server_state, agg_state, x, tau_up, tau_dd, self.A)
        if self.vectors:
            params, server_state, agg_state, rest[-1], m = self.round_fn(*args, rest[-1])
        else:
            params, server_state, agg_state, m = self.round_fn(*args)
        new, treedef = tree.flatten((params, server_state, agg_state, *rest))
        if treedef != self.treedef:
            raise RuntimeError("the round changed the structure of its carry")
        for buf, v in zip(self.bufs, new):
            if not isinstance(buf, torch.Tensor):
                if v is not buf:
                    raise RuntimeError(
                        f"the round replaced a carried {type(buf).__name__}; only tensors "
                        "and generators advanced in place can be carried")
            elif v.shape != buf.shape or v.dtype != buf.dtype:
                raise RuntimeError(f"the round changed a carried tensor from {buf.shape} "
                                   f"{buf.dtype} to {v.shape} {v.dtype}")
            else:
                buf.copy_(v)
        self.metrics.index_copy_(0, i, torch.stack([m[k].float() for k in self.keys])[None])
        for k, buf in self.vectors.items():
            buf.index_copy_(0, i, m[k][None])
        i.add_(1)

    def _load(self, carry, xs, taus, A, K: int) -> None:
        for buf, x in zip(self.bufs, tree.leaves(carry)):
            if isinstance(buf, torch.Tensor):
                _load(buf, x)
        for k, v in xs.items():
            self.xs[k][:K].copy_(v)
        if taus is not None:
            for buf, t in zip(self.taus, taus):
                buf[:K].copy_(t)
        _load(self.A, A)
        self.counter.zero_()

    def _generators(self):
        gens = [b for b in self.bufs if isinstance(b, torch.Generator)]
        return gens + ([self.gen] if self.gen is not None else [])

    def _capture(self, carry, xs, taus, A, K: int) -> None:
        """One eager warm-up round on a side stream (cuDNN's algorithm
        choice, the kernel library's load, the allocator), undone, then the
        capture of one round."""
        dev, stats = self.A.device, self.stats
        gens = self._generators()
        saved = [g.get_state() for g in gens]
        counts0 = launch_counts()
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._load(carry, xs, taus, A, K)
            self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        stats["warmup_s"] = time.perf_counter() - t0
        counts1 = launch_counts()
        # the warm-up must not advance the trajectory: the carry is loaded
        # again before every chunk, the generators are put back here
        for g, state in zip(gens, saved):
            g.set_state(state)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in gens:
            graph.register_generator_state(g)
        torch.cuda.empty_cache()  # what the capture reserves is then its pool alone
        reserved = torch.cuda.memory_reserved(dev)
        # a graph that the collector frees during the capture (destroying a
        # graph is not allowed while a stream captures) would end it: collect
        # first, and not while capturing
        gc.collect()
        gc_enabled = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self.body()
        finally:
            if gc_enabled:
                gc.enable()
        stats["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        stats["instantiate_s"] = time.perf_counter() - t0
        stats["pool_bytes"] = torch.cuda.memory_reserved(dev) - reserved
        counts2 = launch_counts()
        stats["warmup_launches"] = {k: v - counts0[k] for k, v in counts1.items() if v - counts0[k]}
        stats["captured_launches"] = {k: v - counts1[k] for k, v in counts2.items()
                                      if v - counts1[k]}
        stats["buffer_bytes"] = sum(v.numel() * v.element_size() for v in
                                    [*self.xs.values(), *(self.taus or ())])
        stats["replays"] = 0
        stats["captures"] = stats.get("captures", 0) + 1
        self.graph = graph

    def run(self, carry, xs, taus, A, K: int):
        self._load(carry, xs, taus, A, K)
        step = self.graph.replay if self.graph is not None else self.body
        for _ in range(K):
            step()
        if self.graph is not None:
            self.stats["replays"] += K
        metrics = self.metrics[:K].clone()
        out = {k: metrics[:, j] for j, k in enumerate(self.keys)}
        out.update((k, v[:K].clone()) for k, v in self.vectors.items())
        return tree.unflatten(self.treedef, self.bufs), out


def make_async_round_fn(loss_fn: Callable, client_opt: Optimizer, server_opt: Optimizer,
                        rc: RoundConfig, telemetry: bool = False):
    """The async round: :func:`make_round_fn`'s ``per_client`` round over an
    async strategy (``async_colrel``, or an
    :class:`~repro_torch.strategies.AsyncRelayStrategy` around the desired
    inner scheme), whose age vector and staging buffer ride ``agg_state``.
    Same signature and carry; the metrics add the post-delivery staleness
    profile, :data:`ASYNC_METRIC_KEYS`:

    * ``mean_age`` / ``max_age`` — the age vector's mean and max (rounds
      since each client's update last reached the PS);
    * ``stale_frac`` — the fraction of clients aggregated from a stale
      update.

    A sync strategy raises ``ValueError`` rather than running sync
    semantics under the async name.  ``telemetry=True`` instruments the
    round as :func:`make_round_fn` does.
    """
    strategy = rc.resolve_strategy()
    if not getattr(strategy, "is_async", False):
        raise ValueError(
            f"make_async_round_fn needs an async strategy (e.g. 'async_colrel'), got "
            f"{strategy.name!r}; wrap it in AsyncRelayStrategy or use FLTrainer(mode='async')")
    base = make_round_fn(loss_fn, client_opt, server_opt, rc)

    def round_fn(params, server_state, agg_state, batches, tau_up, tau_dd, A):
        params, server_state, agg_state, metrics = base(
            params, server_state, agg_state, batches, tau_up, tau_dd, A)
        age = agg_state["age"].float()
        metrics = dict(metrics, mean_age=torch.mean(age), max_age=torch.max(age),
                       stale_frac=torch.mean((age > 0).float()))
        return params, server_state, agg_state, metrics

    round_fn.metric_keys = METRIC_KEYS + ASYNC_METRIC_KEYS
    if telemetry:
        return instrument_round_fn(round_fn, strategy.wire_bits_per_coord)
    return round_fn


def make_async_scan_round_fn(loss_fn: Callable, client_opt: Optimizer, server_opt: Optimizer,
                             rc: RoundConfig, channel_sampler: Optional[Callable] = None,
                             telemetry: bool = False):
    """The chunked async engine: :func:`make_scan_round_fn`'s signatures
    over :func:`make_async_round_fn`'s body; the age vector and staging
    buffer are static buffers of the captured round, and the staleness
    metrics come back ``(K,)`` like the others."""
    return ScanRound(make_async_round_fn(loss_fn, client_opt, server_opt, rc,
                                         telemetry=telemetry), channel_sampler)

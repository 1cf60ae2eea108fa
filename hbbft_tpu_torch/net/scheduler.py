"""Epoch-pipelined Step pump: the node runtime's scheduler.

Processing every socket event *synchronously inside the transport
callback* (one message → decode → protocol state machine, BLS pairings
included → per-message frame writes, all on the event loop) caps the
sequential path (every protocol round pays a full asyncio wakeup +
per-frame drain) and stalls heartbeats/clients whenever threshold crypto
runs.  This module is a pump instead:

- **Inbox**: transport callbacks only *enqueue* events (peer messages,
  hellos, client/local inputs) — nothing protocol-touching runs on the
  event loop anymore.
- **Adaptive executor offload**: each pump iteration drains a batch of
  events and runs the whole protocol step through ``pump_process``.
  Iterations whose recent cost exceeds ``OFFLOAD_THRESHOLD_S`` (the
  threshold-crypto regime: pairings and MSM folds are multi-ms) run on a
  single worker thread via ``loop.run_in_executor`` so the event loop
  stays responsive (heartbeats, obs scrapes, client acks) while crypto
  grinds; cheap unencrypted iterations (pure Python, well under the
  threshold) run inline, because a thread hop per protocol round costs
  more wall clock than it frees.
  Either way the iterations are strictly serialized by this one pump
  task, so protocol state never sees concurrent access and no
  protocol-level locking exists or is needed.
- **Epoch pipelining**: after the batch, the pump feeds the protocol a
  :class:`~hbbft_tpu_torch.protocols.queueing_honey_badger.PipelineInput` so up
  to ``pipeline_depth`` epochs stay proposed-into at once — epoch e+1's
  RBC/ABA runs while epoch e threshold-decrypts (the ``max_future_epochs``
  window and the SenderQueue's epoch gating are the protocol seam).
  ``pipeline_depth=1`` never emits the input: today's sequential behavior.
- **Cross-epoch batched crypto**: the protocols park threshold-decrypt
  share-set verifications (``HoneyBadger.defer_decrypt``); the pump drains
  them once per iteration via ``resolve_deferred`` — ONE merged
  pairing-product / MSM call for all (epoch, proposer) instances in
  flight (``crypto.batch.verify_dec_share_sets``).
- **Coalesced egress**: a whole iteration's outbound messages are grouped
  per destination and written as MSG_BATCH frames
  (:func:`hbbft_tpu_torch.net.framing.pack_msgs`) — one writer drain per peer
  per iteration instead of one per message.

This module deliberately contains NO direct cryptography: share
generation/verification lives behind the protocols' deferred-resolution
surface and :mod:`hbbft_tpu_torch.crypto.batch`.  On a card, that call's
share-set folds are ``ladder_window`` launches made from each runtime's
worker thread.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter
from typing import Any, Deque, Optional, Tuple

logger = logging.getLogger("hbbft_tpu_torch.net")

#: events drained per executor hop — large enough to amortize the thread
#: hop, small enough to keep egress latency bounded under floods
DEFAULT_MAX_BATCH = 512

#: iterations whose exponentially-weighted recent cost exceeds this run
#: on the executor (loop kept responsive through crypto); below it they
#: run inline (the thread hop would dominate).  The reference's value,
#: meant to sit between an unencrypted round's cost and one host pairing
#: check; not re-measured for the port.
OFFLOAD_THRESHOLD_S = 0.002


class StepPump:
    """The runtime's event pump (see module docstring).

    ``runtime`` must provide ``pump_process(events, depth)`` (worker
    thread: run the batch through the protocol, return an outcome) and
    ``pump_flush(outcome)`` (event loop: write frames / notify clients).
    """

    def __init__(self, runtime: Any, *, pipeline_depth: int = 1,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 tick_s: Optional[float] = None):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if tick_s is not None and tick_s <= 0:
            raise ValueError("tick_s must be > 0 (or None)")
        self.runtime = runtime
        self.pipeline_depth = pipeline_depth
        self.max_batch = max_batch
        # periodic wake: with tick_s set, the pump also wakes every
        # tick_s while IDLE and calls runtime.pump_tick() after every
        # cycle — the adaptive-degradation controller's heartbeat
        # (recovery must proceed on a quiet node, which an event-driven
        # pump would never revisit)
        self.tick_s = tick_s
        self._inbox: Deque[Tuple[str, tuple, float]] = deque()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hbbft-pump"
        )
        self._stopped = False
        #: terminal pump failure, if any (run_node watches the task)
        self.error: Optional[BaseException] = None
        self.iterations = 0
        self.offloaded = 0
        #: cumulative pump CPU seconds (thread time summed across
        #: iterations, inline or offloaded) — the perf plane's
        #: pump-layer CPU source, sampled by counter snapshot
        self.cpu_seconds = 0.0
        # EWMA of recent iteration cost drives the inline-vs-executor
        # decision; it starts cheap (inline) and a single expensive
        # iteration (first pairing burst) flips it within a few rounds
        self._cost_ewma = 0.0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        if self._inbox:
            # events enqueued before start (e.g. a connect() racing the
            # runtime's start) must drive the first iteration themselves
            self._wake.set()
        self._task = loop.create_task(self._run(), name="hbbft-step-pump")

    @property
    def task(self) -> Optional[asyncio.Task]:
        return self._task

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            # suppress: awaiting our own cancelled task; a real pump
            # failure was already recorded in self.error and journaled
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
        # wait=True: cancelling the run_in_executor await does NOT
        # interrupt an in-flight pump_process on the worker thread — it
        # must finish BEFORE the runtime closes the transport and flight
        # recorder, or its tail writes land on closed handles (a torn
        # journal exactly where the black box matters most).  The block
        # is bounded by one iteration (~ms; worst case one pairing burst).
        self._executor.shutdown(wait=True)

    # -- ingress (event-loop side) -------------------------------------------

    def enqueue(self, kind: str, *args) -> None:
        """Queue one event; processing order is strict FIFO.

        Each event carries its enqueue time (``perf_counter``) so the
        pump can account queue-wait — the latency the event spent parked
        in the inbox before its iteration started — in the
        ``hbbft_pump_segment_seconds`` histogram and the per-tx critical
        path."""
        self._inbox.append((kind, args, perf_counter()))
        if self._wake is not None:
            self._wake.set()

    def pending(self) -> int:
        return len(self._inbox)

    # -- the pump ------------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        tick = getattr(self.runtime, "pump_tick", None)
        try:
            while not self._stopped:
                if self.tick_s is None or self._wake.is_set():
                    # busy path: no timer — a wait_for here would mint a
                    # Task + TimerHandle per iteration, and that garbage
                    # churn alone measurably fattens p99 under load
                    await self._wake.wait()
                else:
                    handle = loop.call_later(self.tick_s, self._wake.set)
                    await self._wake.wait()
                    handle.cancel()
                self._wake.clear()
                while self._inbox and not self._stopped:
                    n = min(len(self._inbox), self.max_batch)
                    batch = [self._inbox.popleft() for _ in range(n)]
                    if self._cost_ewma > OFFLOAD_THRESHOLD_S:
                        self.offloaded += 1
                        outcome = await loop.run_in_executor(
                            self._executor, self.runtime.pump_process,
                            batch, self.pipeline_depth,
                        )
                    else:
                        outcome = self.runtime.pump_process(
                            batch, self.pipeline_depth
                        )
                    # outcome.cpu_s is the iteration's THREAD time: on a
                    # contended host, wall time would read preemption as
                    # "expensive work" and flip everything to the
                    # executor, where the extra thread churn makes the
                    # contention worse
                    self._cost_ewma = (
                        0.7 * self._cost_ewma + 0.3 * outcome.cpu_s
                    )
                    self.cpu_seconds += outcome.cpu_s
                    self.iterations += 1
                    self.runtime.pump_flush(outcome)
                if tick is not None:
                    # after the drain (or an idle timeout): the
                    # controller tick stays serialized with pump_process
                    # iterations, so its lever mutations (batch size,
                    # mempool ceilings) never race the proposer
                    tick()
        except asyncio.CancelledError:
            raise
        except BaseException as exc:
            # fatal in the consensus path: the runtime already journaled
            # (flight_crash in _absorb); record and re-raise so the node
            # process dies loudly instead of wedging silently
            self.error = exc
            logger.error("step pump died: %r", exc)
            raise

"""Queueing HoneyBadger: the user-facing transaction buffer.

Reference: ``src/queueing_honey_badger/`` + ``src/transaction_queue.rs`` —
wraps ``DynamicHoneyBadger`` with a transaction queue: user transactions are
buffered; each epoch the node proposes a *random sample* of ``batch_size``
transactions (random so that distinct nodes' proposals overlap little —
the HoneyBadger paper's throughput trick); committed transactions are removed
everywhere; leftovers are re-proposed.

Divergence from the reference worth knowing: a node with an empty queue also
proposes an empty contribution once it sees consensus activity for the
current epoch, so epochs complete without requiring ≥ N−f non-empty queues.

The port's copy of the JAX package's module.  ``TransactionQueue`` and the
transaction-list codec are also what the array-mode driver
``parallel/qhb.py`` uses.  The wrapped ``DynamicHoneyBadger`` owns the
device.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    Change,
    ChangeInput,
    ChangeState,
    DhbBatch,
    DynamicHoneyBadger,
    HbWrap,
    UserInput,
)
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

NodeId = Hashable


class TransactionQueue:
    """Reference: ``src/transaction_queue.rs :: trait TransactionQueue``.

    Random sampling (``choose``) keeps different nodes' batch proposals
    mostly disjoint, which is what makes N proposals per epoch add up to
    N× throughput instead of N× duplication.
    """

    def __init__(self):
        self._txs: List[bytes] = []
        self._set: Dict[bytes, int] = {}

    def extend(self, txs: Sequence[bytes]) -> None:
        for tx in txs:
            tx = bytes(tx)
            if tx not in self._set:
                self._set[tx] = 1
                self._txs.append(tx)

    def remove_multiple(self, txs) -> int:
        """Drop ``txs`` from the queue; returns how many were present
        (the overload guard's shed path needs to know whether a tx was
        actually still queued)."""
        # accept a pre-built set: the QHB commit prunes N queues with the
        # same epoch batch, and rebuilding the drop set per queue is O(N²)
        # across the network (16.7M hashes per epoch at N=4096)
        drop = txs if isinstance(txs, (set, frozenset)) else {
            bytes(t) for t in txs
        }
        if not drop:
            return 0
        before = len(self._txs)
        self._txs = [t for t in self._txs if t not in drop]
        # iterate the smaller side: a node's queue is usually far smaller
        # than the network-wide epoch batch
        if len(self._set) < len(drop):
            for t in [t for t in self._set if t in drop]:
                del self._set[t]
        else:
            for t in drop:
                self._set.pop(t, None)
        return before - len(self._txs)

    def choose(self, rng: random.Random, amount: int,
               exclude: Optional[set] = None) -> List[bytes]:
        """Sample ``amount`` txs; with ``exclude`` (the pipelined
        proposer's in-flight set), sample only txs not already riding an
        open epoch — a duplicate commit wastes a slot in BOTH epochs and
        holds the client's latency to the later one."""
        if exclude:
            fresh = [t for t in self._txs if t not in exclude]
            if amount >= len(fresh):
                return fresh
            return rng.sample(fresh, amount)
        if amount >= len(self._txs):
            return list(self._txs)
        return rng.sample(self._txs, amount)

    def __len__(self) -> int:
        return len(self._txs)


def _ser_txs(txs: Sequence[bytes]) -> bytes:
    out = wire.u32(len(txs))
    for tx in txs:
        out += wire.blob(tx)
    return out


def _de_txs(data: bytes) -> Tuple[bytes, ...]:
    r = wire.Reader(data)
    n = r.u32()
    if n > 1_000_000:
        raise ValueError("absurd tx count")
    return tuple(r.blob() for _ in range(n))


@dataclass(frozen=True)
class QhbBatch:
    """A committed batch of transactions (decoded DHB batch)."""

    era: int
    epoch: int
    contributions: Tuple[Tuple[NodeId, Tuple[bytes, ...]], ...]
    change: ChangeState

    def all_txs(self) -> List[bytes]:
        out = []
        seen = set()
        for _, txs in self.contributions:
            for tx in txs:
                if tx not in seen:
                    seen.add(tx)
                    out.append(tx)
        return out


@dataclass(frozen=True)
class TxInput:
    tx: bytes


@dataclass(frozen=True)
class PipelineInput:
    """Driver input: keep up to ``depth`` epochs proposed-into at once.

    The epoch-pipelined node runtime feeds one per pump iteration; a
    simulator can inject them between cranks to exercise the same
    concurrency deterministically.  ``depth=1`` is a no-op (the normal
    one-epoch-at-a-time proposal flow)."""

    depth: int


class QueueingHoneyBadgerBuilder:
    """Reference: ``queueing_honey_badger.rs :: QueueingHoneyBadgerBuilder``
    (batch_size + rng + queue knobs over a DynamicHoneyBadger)."""

    def __init__(self, dhb):
        self._dhb = dhb
        self._batch_size = 100
        self._rng = None
        self._queue = None

    def batch_size(self, n: int) -> "QueueingHoneyBadgerBuilder":
        self._batch_size = n
        return self

    def rng(self, rng) -> "QueueingHoneyBadgerBuilder":
        self._rng = rng
        return self

    def queue(self, q) -> "QueueingHoneyBadgerBuilder":
        self._queue = q
        return self

    def build(self) -> "QueueingHoneyBadger":
        return QueueingHoneyBadger(
            self._dhb,
            batch_size=self._batch_size,
            rng=self._rng,
            queue=self._queue,
        )


class QueueingHoneyBadger(ConsensusProtocol):
    """Reference: ``queueing_honey_badger.rs :: QueueingHoneyBadger<T,N,Q>``."""

    def __init__(
        self,
        dhb: DynamicHoneyBadger,
        batch_size: int = 100,
        rng: Optional[random.Random] = None,
        queue: Optional[TransactionQueue] = None,
    ):
        self.dhb = dhb
        self.batch_size = batch_size
        self.rng = rng or random.Random(0)
        self.queue = queue or TransactionQueue()
        self.dhb.empty_contribution = _ser_txs([])
        # pipelined proposals only: txs we proposed into epochs that have
        # not committed yet, keyed by (era, epoch) — propose_ahead samples
        # around them so concurrent epochs carry disjoint fresh txs
        # instead of duplicating in-flight ones (bounded by depth entries;
        # commits and era rotations prune)
        self._proposed: Dict[Tuple[int, int], Tuple[bytes, ...]] = {}
        # DHB's DKG keep-alive proposes REAL transactions, not empties
        self._install_provider()

    def _install_provider(self) -> None:
        self.dhb.contribution_provider = lambda: _ser_txs(
            self.queue.choose(self.rng, self.batch_size)
        )

    def __setstate__(self, state):
        # snapshot/restore: DHB drops the (unpicklable) provider closure
        self.__dict__.update(state)
        self.__dict__.setdefault("_proposed", {})
        self._install_provider()

    @classmethod
    def builder(cls, dhb) -> "QueueingHoneyBadgerBuilder":
        return QueueingHoneyBadgerBuilder(dhb)

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self) -> NodeId:
        return self.dhb.our_id()

    def terminated(self) -> bool:
        return False

    def handle_input(self, input) -> Step:
        if isinstance(input, TxInput):
            return self.push_transaction(input.tx)
        if isinstance(input, ChangeInput):
            step = self.dhb.vote_for(input.change)
            return step.extend(self._maybe_propose(force=True))
        if isinstance(input, PipelineInput):
            return self.propose_ahead(input.depth)
        raise TypeError(f"unknown QHB input {input!r}")

    def push_transaction(self, tx: bytes) -> Step:
        """Buffer a transaction and propose if we haven't this epoch."""
        self.queue.extend([tx])
        return self._maybe_propose(force=True)

    def handle_message(self, sender_id: NodeId, message) -> Step:
        step = self._process(self.dhb.handle_message(sender_id, message))
        # if consensus activity exists for the current epoch and we haven't
        # proposed, contribute (possibly an empty sample) to keep it live
        # (the has_input pre-check keeps the common already-proposed case
        # allocation-free — _maybe_propose re-checks it authoritatively)
        if (
            isinstance(message, HbWrap)
            and message.era == self.dhb.era
            and not self.dhb.hb.has_input.get(self.dhb.hb.epoch)
            and self.dhb.hb.epoch in self.dhb.hb.epochs
        ):
            step.extend(self._maybe_propose(force=True))
        return step

    def propose_ahead(self, depth: int) -> Step:
        """Epoch pipelining: sample and propose into every epoch in
        ``[hb.epoch, hb.epoch + depth)`` that lacks our contribution, so
        epoch e+1's RBC/ABA starts while epoch e threshold-decrypts.

        Gated three ways: only with queued transactions (an idle cluster
        must not spin empty epochs), only while no membership change is in
        progress (a DKG rotation would orphan the future epochs' work),
        and never past the protocol's ``max_future_epochs`` window.  A
        transaction can be sampled into several in-flight epochs and then
        commit more than once; duplicate commits are idempotent at every
        consumer (queue pruning, mempool, client notification) — the
        standard cost of pipelined HoneyBadger, paid for ~depth× epoch
        concurrency."""
        if depth <= 1 or not self.dhb.is_validator():
            return Step()
        if self.dhb.change_state.state != "none":
            return Step()
        step = Step()
        for _ in range(depth):
            hb = self.dhb.hb  # re-read: _process can advance/rotate it
            base = hb.epoch
            off = next(
                (
                    k for k in range(min(depth, hb.max_future_epochs + 1))
                    if not hb.has_input.get(base + k)
                ),
                None,
            )
            if off is None or len(self.queue) == 0:
                break
            in_flight = (
                {t for txs in self._proposed.values() for t in txs}
                if self._proposed else None
            )
            sample = self.queue.choose(self.rng, self.batch_size,
                                       exclude=in_flight)
            if not sample:
                # every queued tx already rides an open epoch: an empty
                # filler proposal would spin cheap epochs that commit
                # nothing — let the pipeline refill from fresh traffic
                break
            self._proposed[(self.dhb.era, base + off)] = tuple(sample)
            step.extend(
                self._process(self.dhb.propose_ahead(_ser_txs(sample), off))
            )
        return step

    def has_deferred(self) -> bool:
        return self.dhb.has_deferred()

    def resolve_deferred(self) -> Step:
        return self._process(self.dhb.resolve_deferred())

    # -- internals -----------------------------------------------------------

    def in_flight_txs(self) -> set:
        """Txs riding a not-yet-committed proposal (sequential AND
        pipelined — both record into ``_proposed``): a shed of one of
        these cannot stop it committing, so the overload guard must not
        tell the client otherwise."""
        return {t for txs in self._proposed.values() for t in txs}

    def _maybe_propose(self, force: bool = False) -> Step:
        if not self.dhb.is_validator():
            return Step()
        if self.dhb.hb.has_input.get(self.dhb.hb.epoch):
            return Step()
        if not force and len(self.queue) == 0:
            return Step()
        sample = self.queue.choose(self.rng, self.batch_size)
        if sample:
            # recorded for propose_ahead's exclusion only — the sequential
            # path's own sampling is untouched (depth-1 determinism)
            self._proposed[(self.dhb.era, self.dhb.hb.epoch)] = tuple(sample)
        return self._process(self.dhb.propose(_ser_txs(sample)))

    def _process(self, inner: Step) -> Step:
        """Decode DHB batches into tx batches and update the queue."""
        if not inner.output:
            # nothing to decode and nothing dropped: the common
            # (mid-epoch) per-message case — pass the step through
            # without re-allocating it
            return inner
        step = Step(
            fault_log=inner.fault_log, messages=inner.messages
        )
        for out in inner.output:
            if not isinstance(out, DhbBatch):
                continue
            contribs: List[Tuple[NodeId, Tuple[bytes, ...]]] = []
            committed: List[bytes] = []
            for proposer, payload in out.contributions:
                try:
                    txs = _de_txs(payload)
                except ValueError:
                    step.fault(
                        proposer, FaultKind.BatchDeserializationFailed
                    )
                    continue
                contribs.append((proposer, txs))
                committed.extend(txs)
            self.queue.remove_multiple(committed)
            # this epoch's proposal landed (and any stale older-era /
            # older-epoch records with it): stop excluding its txs
            for k in [k for k in self._proposed
                      if k <= (out.era, out.epoch)]:
                del self._proposed[k]
            step.output.append(
                QhbBatch(
                    era=out.era,
                    epoch=out.epoch,
                    contributions=tuple(contribs),
                    change=out.change,
                )
            )
        # a batch completed → next epoch began: re-propose leftovers
        if step.output:
            step.extend(self._maybe_propose())
        return step

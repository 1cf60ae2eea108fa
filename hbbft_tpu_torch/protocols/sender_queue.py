"""SenderQueue: buffer messages for peers in earlier epochs.

Reference: ``src/sender_queue/`` — wraps HoneyBadger/DHB/QHB so that
messages addressed to a peer that has not yet reached the message's epoch
are held back until the peer announces (via ``EpochStarted``) that it can
process them, bounding "future epoch" drops/faults on real networks where
nodes progress at different speeds.

Epoch keys are (era, epoch) tuples ordered lexicographically; plain
HoneyBadger uses era 0.  A message is deliverable to a peer once
``msg_key ≤ (peer_era, peer_epoch + max_future_epochs)``.

The port's copy of the JAX package's module.  It is host bookkeeping; the
wrapped protocol carries the device.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Tuple

from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    DhbBatch,
    DynamicHoneyBadger,
    HbWrap,
    KeyGenWrap,
)
from hbbft_tpu_torch.protocols.honey_badger import (
    Batch as HbBatch,
    DecryptionShareWrap,
    HoneyBadger,
    SubsetWrap,
)
from hbbft_tpu_torch.protocols.queueing_honey_badger import QhbBatch, QueueingHoneyBadger
from hbbft_tpu_torch.protocols.vid import VidDisperse, VidVote
from hbbft_tpu_torch.traits import ConsensusProtocol, Step, Target, TargetedMessage

NodeId = Hashable
EpochKey = Tuple[int, int]


@dataclass(frozen=True)
class EpochStarted:
    key: EpochKey


@dataclass(frozen=True)
class AlgoMessage:
    msg: Any


def message_key(msg: Any) -> EpochKey:
    """The (era, epoch) a message belongs to.

    Every message type the wrapped algorithms emit is enumerated; an unknown
    type is a bug in the wrapper, not an always-deliverable message, so it
    raises instead of silently bypassing the buffering discipline."""
    if isinstance(msg, (SubsetWrap, DecryptionShareWrap)):
        return (0, msg.epoch)
    if isinstance(msg, HbWrap):
        inner = msg.msg
        if isinstance(inner, (SubsetWrap, DecryptionShareWrap)):
            return (msg.era, inner.epoch)
        raise TypeError(
            f"SenderQueue: unknown HbWrap inner message {type(inner).__name__}"
        )
    if isinstance(msg, KeyGenWrap):
        return (msg.era, 0)
    if isinstance(msg, (VidDisperse, VidVote)):
        # dispersal runs ahead of the epoch it will be proposed into:
        # deliverable to any peer inside the message's era
        return (msg.era, 0)
    raise TypeError(
        f"SenderQueue: no epoch key rule for {type(msg).__name__}"
    )


def _algo_key(algo: Any) -> EpochKey:
    if isinstance(algo, QueueingHoneyBadger):
        return (algo.dhb.era, algo.dhb.hb.epoch)
    if isinstance(algo, DynamicHoneyBadger):
        return (algo.era, algo.hb.epoch)
    if isinstance(algo, HoneyBadger):
        return (0, algo.epoch)
    raise TypeError(f"SenderQueue cannot wrap {type(algo)!r}")


def _algo_window(algo: Any) -> int:
    if isinstance(algo, QueueingHoneyBadger):
        return algo.dhb.max_future_epochs
    if isinstance(algo, DynamicHoneyBadger):
        return algo.max_future_epochs
    return algo.max_future_epochs


#: default per-peer backlog ceiling — several full epochs of traffic at
#: any tested topology, far above what an honest laggard accumulates
#: inside its delivery window
DEFAULT_BUFFERED_CAP = 2048


class SenderQueue(ConsensusProtocol):
    """Reference: ``src/sender_queue/mod.rs :: SenderQueue<D>``."""

    def __init__(self, algo: Any, *,
                 buffered_cap: int = DEFAULT_BUFFERED_CAP,
                 on_evict: Optional[Callable[[NodeId, int], None]] = None):
        self.algo = algo
        self.peer_epochs: Dict[NodeId, EpochKey] = {}
        # per-peer buffered (key, message) — HARD-CAPPED per peer: a
        # voted-in joiner that never connects (or a peer wedged far
        # behind its window) must not grow this without bound.  At the
        # cap the backlog front-chops its OLDEST (lowest-epoch) entries,
        # counted per peer: a peer that far behind recovers via snapshot
        # state-sync, which lands it at the current era boundary where
        # the RETAINED (newest) entries are exactly the deliverable ones.
        self.buffered: Dict[NodeId, List[Tuple[EpochKey, Any]]] = {}
        self.buffered_cap = int(buffered_cap)
        self.evictions: Dict[NodeId, int] = {}
        self.on_evict = on_evict
        # run-long high-water mark of any peer's backlog, recorded
        # BEFORE the cap chops (so a broken chop shows up as a growing
        # peak — a post-chop reading would hold ≤ cap by construction
        # and could never fail).  A working cap keeps this ≤ cap + 1
        # (the one just-inserted entry).  Plain int: samplers on other
        # threads read it without racing the list mutations.
        self.buffered_peak = 0
        self.last_announced: Optional[EpochKey] = None
        # _known_peers runs once per posted Step (hot path): cache the
        # sorted peer list, keyed on what can change it — a new peer in
        # peer_epochs or a fresh NetworkInfo after an era rotation
        self._peers_cache: Optional[List[NodeId]] = None
        self._peers_not_us: List[NodeId] = []
        self._peers_cache_key: Tuple[Any, int] = (None, -1)

    def startup_step(self) -> Step:
        """Announce our epoch so peers learn we exist.

        An observer/candidate is not in the validators' ``netinfo``, so their
        SenderQueues would never address it; its ``EpochStarted`` broadcast
        registers it with every peer (reference: the sender queue's peer
        transitions).  Call once when joining a network.
        """
        cur = _algo_key(self.algo)
        self.last_announced = cur
        return Step().send(Target.all(), EpochStarted(cur))

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self) -> NodeId:
        return self.algo.our_id()

    def terminated(self) -> bool:
        return self.algo.terminated()

    def handle_input(self, input) -> Step:
        return self._post(self.algo.handle_input(input))

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if isinstance(message, EpochStarted):
            return self._peer_advanced(sender_id, message.key)
        if isinstance(message, AlgoMessage):
            return self._post(self.algo.handle_message(sender_id, message.msg))
        raise TypeError(f"unknown sender_queue message {message!r}")

    def handle_message_batch(self, sender_id: NodeId, messages, *,
                             pre=None, on_error=None) -> Step:
        """Handle a whole received batch from one peer, merging the
        per-message Steps into ONE (the runtime's batch-handle fast
        path: one absorb/dispatch per network chunk instead of one per
        message).  Semantically identical to calling
        :meth:`handle_message` per message and joining the Steps —
        output/fault/message order is the concatenation in batch order.

        ``pre(message)`` runs before each message (span/flight hooks);
        ``on_error(message, exc)`` absorbs a per-message ``TypeError``
        (protocol-rejected message — Byzantine attribution) so one bad
        message cannot void the rest of the batch; without it the error
        propagates as before.
        """
        step = Step()
        for message in messages:
            if pre is not None:
                pre(message)
            try:
                step.extend(self.handle_message(sender_id, message))
            except TypeError as exc:
                if on_error is None:
                    raise
                on_error(message, exc)
        return step

    # -- pipelined-runtime passthroughs --------------------------------------

    def has_deferred(self) -> bool:
        """Whether the wrapped algorithm parked deferred crypto work."""
        probe = getattr(self.algo, "has_deferred", None)
        return bool(probe()) if probe is not None else False

    def resolve_deferred(self) -> Step:
        """Drain the wrapped algorithm's deferred crypto (batched share
        verification), with the usual epoch-gated buffering applied to
        whatever messages the resolution emits."""
        resolver = getattr(self.algo, "resolve_deferred", None)
        if resolver is None:
            return Step()
        return self._post(resolver())

    # -- internals -----------------------------------------------------------

    def _cap_backlog(self, peer: NodeId) -> None:
        """Enforce the per-peer backlog ceiling: front-chop the lowest
        (era, epoch) entries beyond ``buffered_cap``, counted.  Epoch
        priority on purpose — the retained NEWEST entries are the ones a
        state-sync'd joiner (activated at the current era boundary) can
        actually use; entries that old were only reachable through a
        full replay the peer has already lost.  Backlogs are kept
        key-sorted at insertion (bisect in ``_post``; ``reinit_peer``
        merges pre-sorted), so the chop is O(drop), not a re-sort per
        buffered message once a peer pins at the cap."""
        entries = self.buffered.get(peer)
        if entries is None:
            return
        if len(entries) > self.buffered_peak:
            self.buffered_peak = len(entries)    # pre-chop, on purpose
        if len(entries) > self.buffered_cap:
            drop = len(entries) - self.buffered_cap
            del entries[:drop]
            self.evictions[peer] = self.evictions.get(peer, 0) + drop
            if self.on_evict is not None:
                self.on_evict(peer, drop)

    def buffered_len(self, peer: NodeId) -> int:
        return len(self.buffered.get(peer, ()))

    def _deliverable(self, key: Optional[EpochKey], peer: NodeId) -> bool:
        if key is None:
            return True
        era, epoch = self.peer_epochs.get(peer, (0, 0))
        window = _algo_window(self.algo)
        return key <= (era, epoch + window)

    def reinit_peer(
        self,
        peer: NodeId,
        key: EpochKey,
        history: Iterable[Tuple[EpochKey, Any]] = (),
    ) -> Step:
        """A peer restarted at ``key``, below its recorded epoch: rewind its
        record and re-feed it the epoch-ordered backlog.

        ``history`` is the caller's replay log of messages that were already
        handed to the network for this peer (the net runtime retains the
        recent (key, message) pairs it sent; ``_peer_advanced`` alone cannot
        help a restarted peer because those messages left the buffer when
        they were first deliverable).  The backlog — history merged with
        anything still buffered here — is re-run through the buffering
        discipline: messages within the peer's new window are re-sent now,
        the rest are held back and flow in order as the peer announces
        ``EpochStarted`` progress while it replays the protocol.

        Duplicates at the peer are safe: the protocols treat a repeated
        well-typed message as a no-op or a logged fault, never corruption.
        The merged backlog is value-deduped so a flapping peer (one
        reinit per reconnect, and reconnects come in pairs — dial and
        accept hellos) cannot accumulate copies of the same held-back
        entries across calls.
        """
        merged = sorted(
            list(history) + self.buffered.pop(peer, []),
            key=lambda kv: kv[0],
        )
        seen: set = set()
        backlog: List[Tuple[EpochKey, Any]] = []
        for entry in merged:
            if entry in seen:
                continue
            seen.add(entry)
            backlog.append(entry)
        self.peer_epochs[peer] = key
        step = Step()
        keep: List[Tuple[EpochKey, Any]] = []
        for mkey, msg in backlog:
            if self._deliverable(mkey, peer):
                step.send_to(peer, AlgoMessage(msg))
            else:
                keep.append((mkey, msg))
        if keep:
            self.buffered[peer] = keep
            self._cap_backlog(peer)
        # re-announce ourselves so the restarted peer learns our epoch and
        # can address us immediately
        cur = _algo_key(self.algo)
        step.send_to(peer, EpochStarted(cur))
        return step

    def _peer_advanced(self, peer: NodeId, key: EpochKey) -> Step:
        cur = self.peer_epochs.get(peer)
        if cur is not None and key <= cur:
            return Step()
        self.peer_epochs[peer] = key  # also registers unknown observers
        step = Step()
        held = self.buffered.pop(peer, [])
        keep: List[Tuple[EpochKey, Any]] = []
        for mkey, msg in held:
            if self._deliverable(mkey, peer):
                step.send_to(peer, AlgoMessage(msg))
            else:
                keep.append((mkey, msg))
        if keep:
            self.buffered[peer] = keep
        return step

    def _post(self, inner: Step) -> Step:
        """Wrap outgoing messages, buffering ones their target can't use yet,
        and announce our own epoch transitions.

        Deliverable recipients of one message share ONE ``AlgoMessage`` /
        ``TargetedMessage`` pair (a multi-node target) instead of a
        per-peer triple — the runtime's ``_dispatch`` resolves targets and
        already encodes per unique inner message, so per-peer wrapping
        only allocated; it never changed what went on the wire."""
        step = Step(output=inner.output, fault_log=inner.fault_log)
        self._known_peers()  # refresh the cache pair
        peers = self._peers_not_us
        window = _algo_window(self.algo)
        peer_epochs = self.peer_epochs
        for tm in inner.messages:
            key = message_key(tm.message)
            target = tm.target
            ready: Optional[List[NodeId]] = None
            for peer in peers:
                if not target.contains(peer):
                    continue
                era, epoch = peer_epochs.get(peer, (0, 0))
                if key <= (era, epoch + window):
                    if ready is None:
                        ready = []
                    ready.append(peer)
                else:
                    # key-sorted insertion (stable within a key): keeps
                    # the backlog in epoch order so the cap's front-chop
                    # and the release paths never need a sort
                    bisect.insort(
                        self.buffered.setdefault(peer, []),
                        (key, tm.message), key=lambda kv: kv[0],
                    )
                    self._cap_backlog(peer)
            if ready is not None:
                # ALWAYS an explicit node set — never Target.all(): the
                # driver resolves all() against ITS OWN membership view
                # (transport peers / every sim node), which may exceed
                # _known_peers and would bypass the per-peer epoch-gated
                # buffering this wrapper exists to enforce
                step.send(Target.nodes(ready), AlgoMessage(tm.message))
        cur = _algo_key(self.algo)
        if self.last_announced is None or cur > self.last_announced:
            self.last_announced = cur
            step.send(Target.all(), EpochStarted(cur))
        return step

    def _known_peers(self) -> List[NodeId]:
        netinfo = (
            self.algo.dhb.netinfo
            if isinstance(self.algo, QueueingHoneyBadger)
            else self.algo.netinfo
        )
        # the cached netinfo is held by strong reference, so an `is`
        # check can never be fooled by id reuse after an era rotation
        cached_ni, cached_n = self._peers_cache_key
        if (self._peers_cache is None or cached_ni is not netinfo
                or cached_n != len(self.peer_epochs)):
            known = set(netinfo.all_ids()) | set(self.peer_epochs.keys())
            self._peers_cache = sorted(known, key=repr)
            us = self.our_id()
            self._peers_not_us = [n for n in self._peers_cache if n != us]
            self._peers_cache_key = (netinfo, len(self.peer_epochs))
        return self._peers_cache

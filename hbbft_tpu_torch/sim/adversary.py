"""Delivery-schedule adversaries (reference: ``tests/net/adversary.rs``).

An adversary controls the order in which queued messages are delivered and
may tamper with or inject messages.  The BFT protocols must stay correct
under *any* schedule, so tests run each suite under several of these.

The port's copy of the JAX package's ``sim/adversary.py``: the base class,
the schedulers (null, node order, reordering, MITM delay, random), the
equivocating proposer and the network-level zoo (targeted delay,
censorship, eclipse, vote storms, flood, replay-as-spoof, future-epoch spam,
crash at epoch) and the two socket-level adversaries that drive a real
node over ``net/framing`` (garbage streams and identity spoofing).
"""

from __future__ import annotations

import random
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:
    from hbbft_tpu_torch.sim.virtual_net import NetworkMessage, VirtualNet


class Adversary:
    """Base: FIFO delivery, no tampering.

    ``pick_message`` returns the index into the queue to deliver next;
    ``tamper`` may rewrite a message addressed from/to a faulty node.
    Reference: ``trait Adversary { pre_crank, tamper }``.

    Two network-level hooks beyond the reference trait:

    - ``filter_message`` is consulted for EVERY enqueued message (not
      just faulty senders') — returning None removes it from the network.
      Censorship, eclipse and crash-stop adversaries live here: in the
      asynchronous model the network itself is adversarial;
    - ``pre_crank`` runs at the start of every crank (before delivery),
      so time-triggered behavior (heals, releases) can fire even when
      the live queue has momentarily drained.
    """

    def pick_message(self, net: "VirtualNet") -> int:
        return 0

    def pre_crank(self, net: "VirtualNet") -> None:
        """Called at the start of every crank, before delivery."""

    def tamper(self, net: "VirtualNet", msg: "NetworkMessage") -> Optional["NetworkMessage"]:
        """Return a replacement for a message sent BY a faulty node (or None
        to drop it).  Only called for messages from faulty senders."""
        return msg

    def filter_message(self, net: "VirtualNet",
                       msg: "NetworkMessage") -> Optional["NetworkMessage"]:
        """Network-level gate over every enqueued message; None removes
        it (counted in ``net.adversary_filtered``)."""
        return msg


class NullAdversary(Adversary):
    """Honest FIFO scheduler."""


class NodeOrderAdversary(Adversary):
    """Delivers messages grouped by destination node id (lowest first).

    Reference: ``NodeOrderAdversary`` — exposes ordering assumptions.
    """

    def pick_message(self, net: "VirtualNet") -> int:
        order = {nid: i for i, nid in enumerate(sorted(net.node_ids(), key=repr))}
        best, best_key = 0, None
        for i, m in enumerate(net.queue):
            k = order.get(m.to, len(order))
            if best_key is None or k < best_key:
                best, best_key = i, k
        return best


class ReorderingAdversary(Adversary):
    """Deterministically swaps pairs of queued messages before delivery."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def pick_message(self, net: "VirtualNet") -> int:
        if len(net.queue) >= 2 and self.rng.random() < 0.5:
            return 1
        return 0


class MitmDelayAdversary(Adversary):
    """Man-in-the-middle delay schedule against binary agreement.

    Reference: ``tests/binary_agreement_mitm.rs`` — the Moumen-style attack:
    hold back every message to/from a targeted node for as long as the
    budget allows so its estimate keeps lagging the coin.  With a threshold
    (unpredictable) coin the protocol must still terminate; a predictable
    coin could be stalled forever.

    ``max_delay`` is the hold budget (consecutive cranks the target is
    starved).  The no-arg default stays the historical fixed 200; passing
    ``max_delay=None`` draws the budget from the seeded RNG instead
    (uniform in [50, 500]) so campaign cells sweep it with their scenario
    seed rather than all probing one magic number.
    """

    def __init__(self, target, max_delay: Optional[int] = 200,
                 seed: int = 0):
        self.target = target
        self.rng = random.Random(seed)
        if max_delay is None:
            max_delay = 50 + self.rng.randrange(0, 451)
        self.max_delay = max_delay
        self._held = 0

    def pick_message(self, net: "VirtualNet") -> int:
        others = [
            i for i, m in enumerate(net.queue)
            if m.to != self.target and m.sender != self.target
        ]
        if others and self._held < self.max_delay:
            self._held += 1
            return self.rng.choice(others)
        self._held = 0
        return self.rng.randrange(len(net.queue))


class EquivocatingAdversary(Adversary):
    """A faulty node equivocates: the Merkle root carried by its
    root-bearing broadcast messages (Ready/EchoHash/CanDecode, and the
    proof roots of Value/Echo) is rewritten for HALF its peers, so odd-
    and even-indexed destinations observe conflicting values for the same
    RBC slot.  Delivery order stays FIFO — the point is not scheduling
    pressure but producing receiver-side evidence: two nodes holding
    different roots from one sender for one slot, keyed to the
    ``Multiple*`` FaultKind family.

    Deterministic (no RNG): the same run yields the same tampered bytes.
    """

    def tamper(self, net: "VirtualNet", msg: "NetworkMessage"):
        from hbbft_tpu_torch.sim.virtual_net import NetworkMessage

        order = sorted(net.node_ids(), key=repr)
        if order.index(msg.to) % 2 == 0:
            return msg  # even destinations see the honest value
        flipped = _flip_roots(msg.payload)
        if flipped is None:
            return msg
        return NetworkMessage(msg.sender, msg.to, flipped)


def _flip_roots(msg):
    """A copy of ``msg`` with every embedded 32-byte broadcast root's
    last bit flipped (walking the wrapper chain); None if the message
    carries no root."""
    import dataclasses

    from hbbft_tpu_torch.protocols.broadcast import (
        CanDecodeMsg, EchoHashMsg, EchoMsg, ReadyMsg, ValueMsg,
    )

    def flip(root: bytes) -> bytes:
        return root[:-1] + bytes([root[-1] ^ 1])

    if isinstance(msg, (ReadyMsg, EchoHashMsg, CanDecodeMsg)):
        return type(msg)(flip(msg.root))
    if isinstance(msg, (ValueMsg, EchoMsg)):
        proof = dataclasses.replace(msg.proof,
                                    root_hash=flip(msg.proof.root_hash))
        return type(msg)(proof)
    if dataclasses.is_dataclass(msg) and hasattr(msg, "msg"):
        inner = _flip_roots(msg.msg)
        if inner is None:
            return None
        return dataclasses.replace(msg, msg=inner)
    return None


class RandomAdversary(Adversary):
    """Random delivery order with duplication, INJECTION, and TAMPERING.

    Reference: ``RandomAdversary`` — random schedule plus replays, randomly
    mutated copies of in-flight messages re-sent under faulty identities,
    and field-level tampering of faulty nodes' outgoing messages.  Correct
    nodes must treat all of it as noise: at worst the culprits land in
    fault logs; agreement/termination must be unaffected.
    """

    def __init__(self, seed: int = 0, dup_prob: float = 0.05,
                 inject_prob: float = 0.05, tamper_prob: float = 0.3):
        self.rng = random.Random(seed)
        self.dup_prob = dup_prob
        self.inject_prob = inject_prob
        self.tamper_prob = tamper_prob

    def pick_message(self, net: "VirtualNet") -> int:
        from hbbft_tpu_torch.sim.virtual_net import NetworkMessage

        i = self.rng.randrange(len(net.queue))
        if self.rng.random() < self.dup_prob:
            # duplicate: re-enqueue a copy before delivery
            net.queue.append(net.queue[i])
        faulty = [n for n in net.node_ids() if net.nodes[n].is_faulty]
        if faulty and self.rng.random() < self.inject_prob:
            # inject: a mutated copy of a random in-flight message, re-sent
            # under a faulty identity to a random destination
            src = self.rng.choice(faulty)
            template = self.rng.choice(net.queue)
            payload = self._mutate(template.payload)
            dst = self.rng.choice(net.node_ids())
            net.queue.append(NetworkMessage(src, dst, payload))
        return i

    def tamper(self, net: "VirtualNet", msg: "NetworkMessage"):
        """Faulty senders' messages: drop some, corrupt some fields."""
        from hbbft_tpu_torch.sim.virtual_net import NetworkMessage

        roll = self.rng.random()
        if roll < self.tamper_prob / 3:
            return None  # drop
        if roll < self.tamper_prob:
            return NetworkMessage(
                msg.sender, msg.to, self._mutate(msg.payload)
            )
        return msg

    def _mutate(self, msg):
        """Type-aware field corruption of protocol messages (falls back to
        the original object for unknown/deeply-nested types)."""
        import dataclasses

        from hbbft_tpu_torch.protocols.binary_agreement import (
            AuxMsg, BValMsg, ConfMsg, TermMsg,
        )
        from hbbft_tpu_torch.protocols.broadcast import (
            CanDecodeMsg, EchoHashMsg, EchoMsg, ReadyMsg, ValueMsg,
        )

        r = self.rng
        if isinstance(msg, (BValMsg, AuxMsg)):
            if r.random() < 0.5:
                return dataclasses.replace(msg, value=not msg.value)
            return dataclasses.replace(msg, epoch=msg.epoch + r.randrange(1, 3))
        if isinstance(msg, TermMsg):
            return dataclasses.replace(msg, value=not msg.value)
        if isinstance(msg, ConfMsg):
            return dataclasses.replace(
                msg, values=frozenset([r.random() < 0.5])
            )
        if isinstance(msg, (ReadyMsg, EchoHashMsg, CanDecodeMsg)):
            root = bytearray(msg.root)
            root[r.randrange(len(root))] ^= 1 << r.randrange(8)
            return type(msg)(bytes(root))
        if isinstance(msg, (ValueMsg, EchoMsg)):
            proof = msg.proof
            value = bytearray(proof.value)
            if value:
                value[r.randrange(len(value))] ^= 1 << r.randrange(8)
            bad = dataclasses.replace(proof, value=bytes(value))
            return type(msg)(bad)
        if dataclasses.is_dataclass(msg) and hasattr(msg, "msg"):
            try:
                return dataclasses.replace(msg, msg=self._mutate(msg.msg))
            except Exception:
                return msg
        return msg


class TargetedDelayAdversary(Adversary):
    """Targeted message-delay against a SET of victims.

    The zoo generalization of :class:`MitmDelayAdversary`: while a seeded
    hold budget lasts, any message to or from a victim is starved (other
    traffic is delivered first); when the budget runs out the backlog
    floods through at once, and the cycle repeats.  Exposes ordering /
    staleness assumptions without dropping anything.
    """

    def __init__(self, targets, max_hold: Optional[int] = None,
                 seed: int = 0):
        self.targets = set(targets)
        self.rng = random.Random(seed)
        if max_hold is None:
            max_hold = 40 + self.rng.randrange(0, 261)
        self.max_hold = max_hold
        self._held = 0

    def pick_message(self, net: "VirtualNet") -> int:
        others = [
            i for i, m in enumerate(net.queue)
            if m.to not in self.targets and m.sender not in self.targets
        ]
        if others and self._held < self.max_hold:
            self._held += 1
            return self.rng.choice(others)
        self._held = 0
        return self.rng.randrange(len(net.queue))


class CensorshipAdversary(Adversary):
    """Selective censorship by message type and/or peer.

    Messages matching EVERY given criterion (type name anywhere in the
    wrapper chain; sender in ``senders``; destination in ``dests``; a
    ``None`` criterion matches anything) are removed from the network —
    up to a seeded budget, so liveness pressure is real but bounded and
    the protocol's recovery after the censor exhausts itself is part of
    the scenario.  Censored drops are counted both here (``censored``)
    and on the net (``adversary_filtered``).
    """

    def __init__(self, msg_types=(), senders=None, dests=None,
                 budget: Optional[int] = None, seed: int = 0):
        self.msg_types = frozenset(msg_types)
        self.senders = None if senders is None else set(senders)
        self.dests = None if dests is None else set(dests)
        self.rng = random.Random(seed)
        if budget is None:
            budget = 50 + self.rng.randrange(0, 451)
        self.budget = budget
        self.censored = 0

    def filter_message(self, net: "VirtualNet", msg: "NetworkMessage"):
        if self.censored >= self.budget:
            return msg
        if self.senders is not None and msg.sender not in self.senders:
            return msg
        if self.dests is not None and msg.to not in self.dests:
            return msg
        if self.msg_types:
            from hbbft_tpu_torch.sim.trace import msg_type_path

            parts = set(msg_type_path(msg.payload).split("/"))
            if not (parts & self.msg_types):
                return msg
        self.censored += 1
        return None


class EclipseAdversary(Adversary):
    """Eclipse one CORRECT node: every message to or from the victim is
    HELD (not dropped) until the heal, then the backlog is re-injected —
    the victim is cut off while the rest of the cluster makes progress,
    and must catch up from the flood afterwards.

    The heal fires at ``heal_crank`` — or earlier, the moment the rest of
    the network goes QUIESCENT (``net.quiescent``: nothing left in the
    live queue or the shaper's held set — link-shaped traffic in flight
    is not silence), so an eclipse can never deadlock a run whose only
    remaining traffic is the held backlog.  Deterministic: no RNG at all.
    """

    def __init__(self, victim, heal_crank: int):
        self.victim = victim
        self.heal_crank = heal_crank
        self.healed = False
        self._held: List["NetworkMessage"] = []

    def pending(self) -> int:
        return len(self._held)

    def filter_message(self, net: "VirtualNet", msg: "NetworkMessage"):
        if not self.healed and (msg.to == self.victim
                                or msg.sender == self.victim):
            self._held.append(msg)
            return None
        return msg

    def pre_crank(self, net: "VirtualNet") -> None:
        if not self.healed and (net.cranks >= self.heal_crank
                                or net.quiescent):
            self.healed = True
            net.queue.extend(self._held)
            self._held.clear()


class VoteStormAdversary(Adversary):
    """Membership-vote storms: drives DynamicHoneyBadger era rotations
    (and vote chaos) WHILE the link layer is doing its worst.

    On a seeded schedule — a crank threshold, or the moment the network
    goes quiescent, whichever comes first — every correct validator is
    fed a :class:`~hbbft_tpu_torch.protocols.dynamic_honey_badger.ChangeInput`:

    - **coordinated waves** alternate removing and re-adding a victim
      validator, each winning vote starting a REAL SyncKeyGen DKG and
      rotating the era — composed with ``partition-10s`` link shaping
      this is a DKG rotation riding out a partition, ROADMAP item 4's
      named next step;
    - **split waves** (seeded coin) hand half the validators a remove
      vote and half a keep vote: no majority, no rotation, just vote
      traffic piggy-backing on every contribution until a later
      coordinated wave supersedes it (``VoteCounter``'s later-vote-wins
      pressure).

    Deterministic per seed: the schedule depends only on crank counts,
    quiescence, and the seeded RNG.  Injection counts are exposed
    (``waves``, ``injected``) and rotations are visible to the auditor
    as era changes in the committed batches — a clean cell must commit
    across every boundary with all chains agreeing.
    """

    def __init__(self, seed: int = 0, first_crank: int = 300,
                 min_gap: int = 600, max_waves: int = 4, victim=None):
        self.rng = random.Random(seed)
        self.min_gap = min_gap
        self.max_waves = max_waves
        self.victim = victim
        self.waves = 0
        self.injected = 0
        self._next_at = first_crank
        self._removed = False
        self._victim_pk = None

    def pre_crank(self, net: "VirtualNet") -> None:
        if self.waves >= self.max_waves:
            return
        if net.cranks < self._next_at and not (net.quiescent
                                               and net.cranks > 0):
            return
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
            Change, ChangeInput,
        )

        correct = net.correct_ids()
        probe = net.nodes[correct[0]].algorithm
        dhb = getattr(probe, "dhb", probe)
        if dhb.change_state.state != "none":
            # a DKG is already in flight — let it rotate before storming
            # again (retry shortly; quiescence keeps the run alive)
            self._next_at = net.cranks + 200
            return
        keys = dict(dhb.netinfo.public_key_map())
        victim = self.victim if self.victim is not None else correct[-1]
        self.waves += 1
        self._next_at = net.cranks + self.min_gap
        split = self.rng.random() < 0.34
        if not self._removed:
            if victim not in keys:
                return  # victim vanished from the key map: nothing to do
            self._victim_pk = keys[victim]
            target = {k: v for k, v in keys.items() if k != victim}
        else:
            target = dict(keys)
            target[victim] = self._victim_pk
        change = Change.node_change(target)
        if split:
            keep = Change.node_change(keys)
            for i, nid in enumerate(correct):
                net.send_input(
                    nid, ChangeInput(change if i % 2 == 0 else keep))
                self.injected += 1
            return
        self._removed = not self._removed
        for nid in correct:
            net.send_input(nid, ChangeInput(change))
            self.injected += 1


class FloodAdversary(Adversary):
    """Max-rate valid-frame spam from one peer (overload defense drill).

    Every message the flooder emits is amplified ``copies``-fold, and
    each crank the flooder re-injects duplicates of its own in-flight
    traffic — all of it VALID protocol messages, the flood shape a
    budget guard cannot reject on content.  Correct nodes must keep
    committing with every per-peer buffer pinned under its cap: the
    protocols treat duplicates as no-ops, the queues absorb the burst,
    and nothing grows without bound.  The injection budget is seeded so
    the run terminates and replays byte-identically.
    """

    def __init__(self, flooder, seed: int = 0, copies: int = 3,
                 budget: Optional[int] = None):
        self.flooder = flooder
        self.rng = random.Random(seed)
        self.copies = copies
        if budget is None:
            budget = 2_000 + self.rng.randrange(0, 2_001)
        self.budget = budget
        self.injected = 0

    def filter_message(self, net: "VirtualNet", msg: "NetworkMessage"):
        if msg.sender == self.flooder and self.injected < self.budget:
            for _ in range(self.copies):
                if self.injected >= self.budget:
                    break
                net.queue.append(msg)
                self.injected += 1
        return msg

    def pre_crank(self, net: "VirtualNet") -> None:
        if self.injected >= self.budget:
            return
        mine = [m for m in net.queue if m.sender == self.flooder]
        if mine:
            net.queue.append(self.rng.choice(mine))
            self.injected += 1


class SpoofReplayAdversary(FloodAdversary):
    """Replay-as-spoof: the in-sim analog of identity spoofing.

    Under the authenticated transport an attacker cannot FORGE a
    validator's messages — the strongest impersonation left is
    replaying byte-identical copies of messages the victim genuinely
    sent.  Every crank this adversary re-injects seeded duplicates of
    the victim's in-flight traffic (and amplifies fresh emissions
    ``copies``-fold), exactly :class:`FloodAdversary`'s mechanics but
    with an HONEST victim: the protocols treat duplicates as no-ops,
    every node keeps committing, and the cell verdict must stay CLEAN —
    the replayed victim did nothing wrong and must never be blamed for
    traffic it sent once (``spec.faulty`` excludes it)."""

    def __init__(self, victim, seed: int = 0, copies: int = 2,
                 budget: Optional[int] = None):
        super().__init__(victim, seed=seed, copies=copies, budget=budget)
        self.victim = victim


class FutureEpochSpamAdversary(Adversary):
    """Window-edge protocol spam: the spammer injects binary-agreement
    messages addressed to epochs at ``hb.epoch + max_future_epochs`` —
    the farthest epoch a correct node must still accept — with ABA
    epochs fanned across the ABA future window, forcing the receivers'
    future-epoch buffers toward their caps.

    Correct nodes must keep committing, every BA ``future`` buffer must
    stay ≤ ``future_cap_per_sender`` (overflow front-evicts the
    spammer's own entries, counted), and HoneyBadger's per-sender
    future-epoch budget must absorb the rest.  Deterministic per seed.
    """

    def __init__(self, spammer, seed: int = 0, per_wave: int = 40,
                 budget: Optional[int] = None):
        self.spammer = spammer
        self.rng = random.Random(seed)
        self.per_wave = per_wave
        if budget is None:
            # sized so EACH victim's share of the stream exceeds the
            # HoneyBadger per-sender future-epoch budget (the drill must
            # actually make the defense engage, not just approach it)
            budget = 6_000 + self.rng.randrange(0, 3_001)
        self.budget = budget
        self.injected = 0

    def pre_crank(self, net: "VirtualNet") -> None:
        if self.injected >= self.budget or not net.queue:
            return
        from hbbft_tpu_torch.protocols.binary_agreement import (
            AuxMsg, BValMsg,
        )
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import HbWrap
        from hbbft_tpu_torch.protocols.honey_badger import SubsetWrap
        from hbbft_tpu_torch.protocols.sender_queue import AlgoMessage
        from hbbft_tpu_torch.protocols.subset import AgreementWrap
        from hbbft_tpu_torch.sim.virtual_net import NetworkMessage

        correct = net.correct_ids()
        probe = net.nodes[correct[0]].algorithm
        algo = getattr(probe, "algo", probe)          # unwrap SenderQueue
        sender_queued = algo is not probe
        dhb = getattr(algo, "dhb", algo)
        hb = getattr(dhb, "hb", dhb)
        era = getattr(dhb, "era", 0)
        edge = hb.epoch + hb.max_future_epochs        # window edge
        proposers = sorted(net.node_ids(), key=repr)
        for _ in range(self.per_wave):
            if self.injected >= self.budget:
                return
            proposer = proposers[self.rng.randrange(len(proposers))]
            aba_epoch = self.rng.randrange(1, 17)     # BA future window
            cls = BValMsg if self.rng.random() < 0.5 else AuxMsg
            inner = cls(aba_epoch, bool(self.rng.randrange(2)))
            payload = HbWrap(era, SubsetWrap(
                edge, AgreementWrap(proposer, inner)))
            if sender_queued:
                payload = AlgoMessage(payload)
            # the same spam hits EVERY correct node, so each receiver's
            # per-sender budget sees the full stream
            for victim in correct:
                if self.injected >= self.budget:
                    return
                net.queue.append(
                    NetworkMessage(self.spammer, victim, payload))
                self.injected += 1


class GarbageStreamAdversary:
    """Framing-valid, decode-invalid byte streams against a REAL node.

    The socket-kind sibling of :class:`FloodAdversary`: it dials a live
    node's port, completes a node-role hello under a CLAIMED validator
    identity (the transport's documented trust boundary — identification,
    not authentication), then streams MSG frames whose payloads are
    seeded random bytes — every frame passes the length-prefix framing
    layer, every payload fails ``wire.decode_message``.  The victim must
    count each one (``decode_failures`` + guard decode strikes), keep
    committing, and eventually disconnect the stream with a counted
    backoff (``hbbft_guard_ingress_disconnects_total``), which this
    driver observes as connection resets.

    With ``valid_frames=True`` the payloads are instead well-formed
    ``EpochStarted`` announcements — max-rate VALID-frame spam, the
    socket realization of :class:`FloodAdversary`: the byte budget and
    in-flight frame caps are then the only defense that can engage.
    """

    def __init__(self, seed: int = 0, budget_frames: int = 20_000,
                 frame_bytes: int = 256, valid_frames: bool = False,
                 secret_key=None):
        self.rng = random.Random(seed)
        self.budget_frames = budget_frames
        self.frame_bytes = frame_bytes
        self.valid_frames = valid_frames
        # the claimed identity's plain BLS secret key: with it, the
        # drill models a COMPROMISED validator — the handshake
        # challenge is answered correctly and the flood proceeds past
        # an authenticating victim; without it, an auth-enabled victim
        # refuses the hello outright (that refusal is
        # IdentitySpoofAdversary's drill, not this one's)
        self.secret_key = secret_key
        self.frames_sent = 0
        self.bytes_sent = 0
        # connection teardowns observed, INCLUDING hellos refused
        # during the victim's guard backoff window (a refused hello
        # surfaces as the socket closing before any reply — the
        # victim-side hbbft_guard_hello_rejects_total counter is the
        # authoritative per-cause ledger)
        self.disconnects = 0

    def _frame(self) -> bytes:
        from hbbft_tpu_torch.net import framing

        if self.valid_frames:
            if not hasattr(self, "_valid_frame"):
                from hbbft_tpu_torch.protocols import wire
                from hbbft_tpu_torch.protocols.sender_queue import EpochStarted

                # one MSG_BATCH frame carrying hundreds of well-formed
                # EpochStarted announcements: a single socket write
                # floods the victim with valid frames faster than the
                # write path alone ever could
                enc = wire.encode_message(EpochStarted((0, 0)))
                self._valid_frame = framing.pack_msgs(
                    [enc] * 512, framing.DEFAULT_MAX_FRAME)[0]
            return self._valid_frame
        return framing.encode_frame(
            framing.MSG,
            bytes(self.rng.randrange(256)
                  for _ in range(self.frame_bytes)),
            framing.DEFAULT_MAX_FRAME)

    async def run(self, addr, cluster_id: bytes, identity,
                  duration_s: float = 10.0, era: int = 0) -> None:
        """Flood ``addr`` claiming ``identity`` until the frame budget
        or ``duration_s`` runs out, reconnecting through disconnects."""
        import asyncio
        import time as _time

        from hbbft_tpu_torch.net import framing

        deadline = _time.monotonic() + duration_s
        while (self.frames_sent < self.budget_frames
               and _time.monotonic() < deadline):
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*addr), 2.0)
            except (OSError, asyncio.TimeoutError):
                await asyncio.sleep(0.05)
                continue
            try:
                hello = framing.Hello(
                    node_id=identity, role=framing.ROLE_NODE,
                    cluster_id=bytes(cluster_id), era=era, epoch=0)
                writer.write(framing.encode_frame(
                    framing.HELLO, framing.encode_hello(hello),
                    framing.DEFAULT_MAX_FRAME))
                await writer.drain()
                kind, payload = await asyncio.wait_for(
                    framing.read_one_frame(
                        reader, framing.DEFAULT_MAX_FRAME), 2.0)
                if kind == framing.CHALLENGE:
                    # authenticated victim: with the compromised key the
                    # challenge is answered properly (the flood drill
                    # continues past the handshake); without it this
                    # connection is already lost — surface the refusal
                    if self.secret_key is None:
                        raise ConnectionError(
                            "victim demands auth and no key was given")
                    nonce, session = framing.decode_challenge(payload)
                    transcript = framing.auth_transcript(
                        bytes(cluster_id), nonce, session, identity,
                        framing.ROLE_NODE, era)
                    sig = self.secret_key.sign(transcript).to_bytes()
                    writer.write(framing.encode_frame(
                        framing.AUTH, framing.encode_auth(era, sig),
                        framing.DEFAULT_MAX_FRAME))
                    await writer.drain()
                    kind, payload = await asyncio.wait_for(
                        framing.read_one_frame(
                            reader, framing.DEFAULT_MAX_FRAME), 2.0)
                if kind != framing.HELLO:
                    raise ConnectionError(
                        f"unexpected reply kind {kind}")
                while (self.frames_sent < self.budget_frames
                       and _time.monotonic() < deadline):
                    if writer.is_closing():
                        raise ConnectionError("stream torn down")
                    frame = self._frame()
                    writer.write(frame)
                    self.frames_sent += 1
                    self.bytes_sent += len(frame)
                    if self.frames_sent % 16 == 0:
                        await asyncio.wait_for(writer.drain(), 5.0)
            except (OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ConnectionError):
                # the guard tore the stream down (or refused the hello
                # during its backoff window): the defense engaging IS
                # the observable — count it and press on
                self.disconnects += 1
                await asyncio.sleep(0.1)
            finally:
                writer.close()


class IdentitySpoofAdversary:
    """Raw-socket identity theft against an AUTHENTICATED node.

    Dials a live node's port claiming a CORRECT validator identity in
    the hello, then fails the challenge–response in one of four ways:

    - ``nokey``: answers the CHALLENGE with seeded random bytes where
      the era-key signature belongs (an attacker holding no key
      material at all);
    - ``wrongkey``: signs the exact transcript with a DIFFERENT secret
      key (compromised non-validator key trying to impersonate);
    - ``hijack``: skips AUTH entirely and streams a protocol MSG frame
      in its place (inject-before-the-challenge-completes, the
      session-hijack shape);
    - ``downgrade``: signs with the wrong key while claiming an
      ancient era (an era-downgrade probe at the rotation grace
      window).

    The victim must refuse every attempt BEFORE allocating any
    per-peer state: zero spoofed frames reach the protocol, the
    impersonated validator's budgets/strikes stay untouched, and every
    refusal is counted (``hbbft_guard_auth_failures_total``) and
    journaled with the ATTACKER's endpoint — never the victim's.  From
    outside, a refusal is the stream closing without a hello reply;
    ``hellos_accepted`` staying 0 is the spoof-proof acceptance
    criterion this driver can observe directly.
    """

    MODES = ("nokey", "wrongkey", "hijack", "downgrade")

    def __init__(self, seed: int = 0, mode: str = "nokey",
                 secret_key=None, claim_era: int = 0,
                 budget_attempts: int = 40):
        if mode not in self.MODES:
            raise ValueError(f"unknown spoof mode {mode!r}")
        if mode in ("wrongkey", "downgrade") and secret_key is None:
            raise ValueError(f"mode {mode!r} needs a (wrong) secret_key")
        self.rng = random.Random(seed)
        self.mode = mode
        self.secret_key = secret_key
        self.claim_era = claim_era
        self.budget_attempts = budget_attempts
        self.attempts = 0
        #: refusals observed (stream closed / no hello reply) — the
        #: defense engaging, seen from the attacker's side
        self.refusals = 0
        #: spoofed hellos the victim ACCEPTED — must stay 0
        self.hellos_accepted = 0

    def _auth_payload(self, cluster_id: bytes, nonce: bytes,
                      session: bytes, identity) -> bytes:
        from hbbft_tpu_torch.net import framing

        era = self.claim_era
        if self.secret_key is not None:
            transcript = framing.auth_transcript(
                bytes(cluster_id), nonce, session, identity,
                framing.ROLE_NODE, era)
            sig = self.secret_key.sign(transcript).to_bytes()
        else:
            sig = bytes(self.rng.randrange(256) for _ in range(96))
        return framing.encode_auth(era, sig)

    async def run(self, addr, cluster_id: bytes, identity,
                  duration_s: float = 5.0) -> None:
        """Spoof ``identity`` at ``addr`` until the attempt budget or
        ``duration_s`` runs out; every refusal feeds the next try."""
        import asyncio
        import time as _time

        from hbbft_tpu_torch.net import framing

        deadline = _time.monotonic() + duration_s
        while (self.attempts < self.budget_attempts
               and _time.monotonic() < deadline):
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*addr), 2.0)
            except (OSError, asyncio.TimeoutError):
                await asyncio.sleep(0.05)
                continue
            self.attempts += 1
            try:
                hello = framing.Hello(
                    node_id=identity, role=framing.ROLE_NODE,
                    cluster_id=bytes(cluster_id), era=self.claim_era,
                    epoch=0)
                writer.write(framing.encode_frame(
                    framing.HELLO, framing.encode_hello(hello),
                    framing.DEFAULT_MAX_FRAME))
                await writer.drain()
                kind, payload = await asyncio.wait_for(
                    framing.read_one_frame(
                        reader, framing.DEFAULT_MAX_FRAME), 2.0)
                if kind == framing.HELLO:
                    # unauthenticated victim took the spoof at face
                    # value — the exact hole this drill exists to catch
                    self.hellos_accepted += 1
                    continue
                if kind != framing.CHALLENGE:
                    raise ConnectionError(
                        f"unexpected reply kind {kind}")
                nonce, session = framing.decode_challenge(payload)
                if self.mode == "hijack":
                    # stream a protocol frame where AUTH belongs: the
                    # victim must refuse it unparsed (no_auth), not
                    # feed it to the protocol
                    writer.write(framing.encode_frame(
                        framing.MSG,
                        bytes(self.rng.randrange(256)
                              for _ in range(64)),
                        framing.DEFAULT_MAX_FRAME))
                else:
                    writer.write(framing.encode_frame(
                        framing.AUTH,
                        self._auth_payload(cluster_id, nonce, session,
                                           identity),
                        framing.DEFAULT_MAX_FRAME))
                await writer.drain()
                kind, _ = await asyncio.wait_for(
                    framing.read_one_frame(
                        reader, framing.DEFAULT_MAX_FRAME), 2.0)
                if kind == framing.HELLO:
                    self.hellos_accepted += 1
            except (OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ConnectionError,
                    framing.FrameError):
                # refused before the hello reply: the defense held
                self.refusals += 1
                await asyncio.sleep(0.02)
            finally:
                writer.close()


class CrashAtEpochAdversary(Adversary):
    """Crash-stop at epoch: once the victim node has produced
    ``after_batches`` outputs (committed batches for a QHB stack), ALL
    its subsequent traffic — both directions — is removed forever.  The
    fail-stop shape consensus must tolerate for up to f nodes: the
    remaining n−1 keep committing, the victim's ledger freezes at its
    crash point (its journal simply ends — no fork, no fault).

    Deterministic: the trigger is the victim's own output count.
    Messages already in flight at the crash instant still deliver (the
    usual fuzzy crash boundary).
    """

    def __init__(self, victim, after_batches: int = 1):
        self.victim = victim
        self.after_batches = after_batches
        self.crashed = False
        self.dropped = 0

    def filter_message(self, net: "VirtualNet", msg: "NetworkMessage"):
        if not self.crashed:
            node = net.nodes.get(self.victim)
            if node is not None and len(node.outputs) >= self.after_batches:
                self.crashed = True
        if self.crashed and (msg.sender == self.victim
                             or msg.to == self.victim):
            self.dropped += 1
            return None
        return msg

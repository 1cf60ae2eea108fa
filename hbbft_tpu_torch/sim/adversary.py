"""Delivery-schedule adversaries (reference: ``tests/net/adversary.rs``).

An adversary controls the order in which queued messages are delivered and
may tamper with or inject messages.  The BFT protocols must stay correct
under *any* schedule, so tests run each suite under several of these.

The port's copy of the first part of the JAX package's ``sim/adversary.py``:
the base class, the schedulers (null, node order, reordering, MITM delay,
random) and the equivocating proposer.  The zoo beyond them (targeted
delay, censorship, eclipse, crash, flood and the socket-level adversaries)
is not ported yet.
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

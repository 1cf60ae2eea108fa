"""Bracha reliable broadcast with erasure-coded payload.

Reference: ``src/broadcast/broadcast.rs :: Broadcast`` — the proposer
RS-encodes the value into N shards (data = N−2f, parity = 2f), commits to
them with a Merkle tree, and sends each node its shard + proof as ``Value``;
nodes re-distribute their shard to everyone as ``Echo``; ``Ready(root)`` is
sent after N−f Echos (or f+1 Readys — Bracha amplification); the value is
decoded once a node holds 2f+1 Readys and ≥ N−2f Echos, re-encoded, and the
recomputed Merkle root checked against the agreed one.

Guarantees (with ≤ f Byzantine nodes): if any correct node outputs a value,
all correct nodes output that same value; if the proposer is correct, that
value is the proposer's input.

The port's copy of the JAX package's module.  The erasure code goes through
``ops/rs.py``'s host API, whose ``HBBFT_ERASURE_BACKEND`` switch picks the
engine; the ``device`` backend runs it on the instance's ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, Optional, Set, Tuple

import numpy as np

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.ops import rs
from hbbft_tpu_torch.ops.merkle import MerkleTree, Proof
from hbbft_tpu_torch.traits import ConsensusProtocol, Step, Target

NodeId = Hashable


# -- messages (reference: src/broadcast/message.rs :: Message) --------------


@dataclass(frozen=True)
class ValueMsg:
    proof: Proof


@dataclass(frozen=True)
class EchoMsg:
    proof: Proof


@dataclass(frozen=True)
class ReadyMsg:
    root: bytes


@dataclass(frozen=True)
class EchoHashMsg:
    """Echo *evidence* without the shard (reference:
    ``src/broadcast/message.rs :: Message::EchoHash`` [LOW] — the upstream
    message-reduction optimization).  Sent instead of a full ``Echo`` to
    peers that already announced ``CanDecode``: they no longer need the
    shard content, only proof that this sender echoed the root, which is
    all the N−f Ready threshold requires."""

    root: bytes


@dataclass(frozen=True)
class CanDecodeMsg:
    """Announcement that this node holds ≥ N−2f shards for ``root`` and
    needs no further shard payloads (reference: ``Message::CanDecode``
    [LOW]).  Peers that have not echoed to us yet send ``EchoHash``
    instead of the full shard+proof, saving O(N · shard) bytes per node."""

    root: bytes


BroadcastMessage = object  # ValueMsg | EchoMsg | ReadyMsg | EchoHash | CanDecode

#: ``CanDecode`` pays for itself only when the echo shards it suppresses
#: outweigh the announcement messages themselves (~40 framed bytes to
#: N−k peers, plus a full decode/handle pass at every receiver).  Below
#: this shard size the optimization is strictly negative — at the bench
#: shape (64 B txs, shards < 300 B) it added ~8 messages per epoch per
#: node for nothing — so tiny-payload broadcasts skip the announcement.
#: Module knob: MB-scale RBC deployments can tune it.
CAN_DECODE_MIN_SHARD_BYTES = 256


class Broadcast(ConsensusProtocol):
    """Reference: ``src/broadcast/broadcast.rs :: Broadcast<N>``."""

    def __init__(self, netinfo: NetworkInfo, proposer_id: NodeId,
                 device="cuda"):
        if not netinfo.is_node_validator(proposer_id):
            raise ValueError("proposer is not a validator")
        self.netinfo = netinfo
        self.proposer_id = proposer_id
        # where the erasure code runs under the ``device`` backend
        self.device = resolve_device(device)
        n = netinfo.num_nodes()
        f = netinfo.num_faulty()
        self.coder = rs.for_n_f(n, f)
        self.data_shard_num = self.coder.data_shards
        # state (reference field names)
        self.echo_sent = False
        self.ready_sent = False
        self.decided = False
        self.value_received = False
        self.value_proof: Optional[Proof] = None
        self.echos: Dict[NodeId, Proof] = {}
        self.echo_hashes: Dict[NodeId, bytes] = {}  # shard-less echo evidence
        # peers that need no shard, keyed per root hash on BOTH sides (as in
        # the reference, which maps hash → senders): under an equivocating
        # proposer an honest node may legitimately announce CanDecode for a
        # losing root and later for the winning one — neither direction may
        # suppress or fault that
        self.can_decodes: Dict[NodeId, set] = {}
        self.can_decode_sent: set = set()  # roots we announced
        self.readys: Dict[NodeId, bytes] = {}
        self.output: Optional[bytes] = None
        self.fault: bool = False  # proposer proven faulty (root mismatch)

    # -- ConsensusProtocol --------------------------------------------------

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return self.decided or self.fault

    def handle_input(self, input: bytes) -> Step:
        """Proposer entry point (reference ``Broadcast::broadcast``)."""
        if self.our_id() != self.proposer_id:
            raise ValueError("only the proposer can input a value")
        if self.value_received:
            return Step()
        return self._send_shards(bytes(input))

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            return Step.from_fault(sender_id, FaultKind.UnknownSender)
        if isinstance(message, ValueMsg):
            return self._handle_value(sender_id, message.proof)
        if isinstance(message, EchoMsg):
            return self._handle_echo(sender_id, message.proof)
        if isinstance(message, ReadyMsg):
            return self._handle_ready(sender_id, message.root)
        if isinstance(message, EchoHashMsg):
            return self._handle_echo_hash(sender_id, message.root)
        if isinstance(message, CanDecodeMsg):
            return self._handle_can_decode(sender_id, message.root)
        raise TypeError(f"unknown broadcast message {message!r}")

    # -- internals ----------------------------------------------------------

    def _send_shards(self, value: bytes) -> Step:
        """RS-encode + Merkle-commit + send per-node ``Value`` proofs.

        Reference: ``Broadcast::send_shards`` (HOT: GF(2^8) matmul + keccak;
        the batched drivers replace this whole path with
        ``parallel.rbc.BatchedRbc``).
        """
        self.value_received = True
        shards, leaves = _encode_value(self.coder, value, self.device)
        tree = MerkleTree.from_shards(shards, leaves)
        step = Step()
        my_proof = None
        ids = self.netinfo.all_ids()
        for i, nid in enumerate(ids):
            proof = tree.proof(i)
            if nid == self.our_id():
                my_proof = proof
            else:
                step.send_to(nid, ValueMsg(proof))
        if my_proof is not None:
            step.extend(self._handle_value(self.our_id(), my_proof))
        return step

    def _validate_proof(self, proof: Proof, sender_id: NodeId) -> bool:
        """Proof must verify and carry the index of ``sender_id``.

        Reference: ``Broadcast::validate_proof``.
        """
        idx = self.netinfo.node_index(sender_id)
        return (
            proof.index == idx
            and proof.validate(self.netinfo.num_nodes())
        )

    def _handle_value(self, sender_id: NodeId, proof: Proof) -> Step:
        if sender_id != self.proposer_id:
            return Step.from_fault(sender_id, FaultKind.NotAProposer)
        if self.value_received and sender_id != self.our_id():
            if proof == self.value_proof:
                return Step()  # network replay — idempotent
            return Step.from_fault(sender_id, FaultKind.MultipleValues)
        self.value_received = True
        self.value_proof = proof
        # a Value for us carries OUR shard index
        if proof.index != self.netinfo.node_index(self.our_id()) or not proof.validate(
            self.netinfo.num_nodes()
        ):
            return Step.from_fault(sender_id, FaultKind.InvalidProof)
        step = Step()
        if not self.echo_sent:
            self.echo_sent = True
            # full shard+proof to everyone still needing shards (Target::All
            # so observers are reached too); hash-only evidence to peers
            # that already announced CanDecode(root)
            root = proof.root_hash
            cd_peers = {
                nid for nid, roots in self.can_decodes.items()
                if root in roots and nid != self.our_id()
            }
            if cd_peers:
                for nid in cd_peers:
                    step.send_to(nid, EchoHashMsg(root))
                step.send(Target.all_except(cd_peers), EchoMsg(proof))
            else:
                step.send_all(EchoMsg(proof))
            step.extend(self._handle_echo(self.our_id(), proof))
        return step

    def _handle_echo(self, sender_id: NodeId, proof: Proof) -> Step:
        if sender_id in self.echos:
            if self.echos[sender_id] == proof:
                return Step()
            return Step.from_fault(sender_id, FaultKind.MultipleEchos)
        if self.echo_hashes.get(sender_id, proof.root_hash) != proof.root_hash:
            return Step.from_fault(sender_id, FaultKind.EchoHashConflict)
        if not self._validate_proof(proof, sender_id):
            return Step.from_fault(sender_id, FaultKind.InvalidProof)
        self.echos[sender_id] = proof
        step = Step()
        root = proof.root_hash
        step.extend(self._maybe_send_can_decode(root))
        step.extend(self._maybe_send_ready(root))
        step.extend(self._try_decode())
        return step

    def _handle_echo_hash(self, sender_id: NodeId, root: bytes) -> Step:
        if sender_id in self.echo_hashes:
            if self.echo_hashes[sender_id] == root:
                return Step()
            return Step.from_fault(sender_id, FaultKind.MultipleEchoHashes)
        prev = self.echos.get(sender_id)
        if prev is not None and prev.root_hash != root:
            return Step.from_fault(sender_id, FaultKind.EchoHashConflict)
        self.echo_hashes[sender_id] = root
        # no _try_decode here: an EchoHash adds neither a shard nor a
        # Ready, so it can only matter through the Ready threshold (and
        # _handle_ready runs _try_decode itself)
        return self._maybe_send_ready(root)

    def _handle_can_decode(self, sender_id: NodeId, root: bytes) -> Step:
        roots = self.can_decodes.setdefault(sender_id, set())
        # Honest bound: CanDecode(root) requires ≥ k = N−2f full echoes for
        # that root, each sender's echo binds to ONE root (MultipleEchos is
        # a fault), and k ≥ (N+2)/3, so at most ⌊N/k⌋ ≤ 2 distinct roots
        # can ever cross the threshold at one node.  A repeat for the same
        # root, or a third root, is therefore provably faulty — and the
        # bound keeps per-sender state O(1) against root-spamming peers.
        if root in roots or len(roots) >= 2:
            return Step.from_fault(sender_id, FaultKind.MultipleCanDecodes)
        roots.add(root)
        return Step()

    def _maybe_send_ready(self, root: bytes) -> Step:
        """N−f echo *evidence* (full shards or hashes) → send Ready."""
        step = Step()
        n, f = self.netinfo.num_nodes(), self.netinfo.num_faulty()
        if self._count_echo_evidence(root) >= n - f and not self.ready_sent:
            self.ready_sent = True
            step.send_all(ReadyMsg(root))
            step.extend(self._handle_ready(self.our_id(), root))
        return step

    def _maybe_send_can_decode(self, root: bytes) -> Step:
        """≥ N−2f full shards in hand → tell peers to stop sending shards.

        Sent only to peers whose full Echo has NOT already arrived — the
        others have nothing left to withhold (reference sends AllExcept)."""
        step = Step()
        if (
            root not in self.can_decode_sent
            and not self.decided
            and self._count_echos(root) >= self.data_shard_num
        ):
            self.can_decode_sent.add(root)
            shard_len = max(
                len(p.value)
                for p in self.echos.values() if p.root_hash == root
            )
            if shard_len >= CAN_DECODE_MIN_SHARD_BYTES:
                step.send(
                    Target.all_except(set(self.echos)), CanDecodeMsg(root)
                )
        return step

    def _handle_ready(self, sender_id: NodeId, root: bytes) -> Step:
        if sender_id in self.readys:
            if self.readys[sender_id] == root:
                return Step()
            return Step.from_fault(sender_id, FaultKind.MultipleReadys)
        self.readys[sender_id] = root
        step = Step()
        f = self.netinfo.num_faulty()
        if self._count_readys(root) > f and not self.ready_sent:
            # Bracha amplification
            self.ready_sent = True
            step.send_all(ReadyMsg(root))
            step.extend(self._handle_ready(self.our_id(), root))
        step.extend(self._try_decode())
        return step

    def _count_echos(self, root: bytes) -> int:
        return sum(1 for p in self.echos.values() if p.root_hash == root)

    def _count_echo_evidence(self, root: bytes) -> int:
        """Distinct senders known to have echoed ``root`` — full shards plus
        hash-only EchoHash evidence (enough for the Ready threshold; decode
        still requires ``data_shard_num`` full shards)."""
        senders = {
            nid for nid, p in self.echos.items() if p.root_hash == root
        }
        senders |= {
            nid for nid, r in self.echo_hashes.items() if r == root
        }
        return len(senders)

    def _count_readys(self, root: bytes) -> int:
        return sum(1 for r in self.readys.values() if r == root)

    def _try_decode(self) -> Step:
        """Reference: ``Broadcast::compute_output`` — decode when 2f+1
        Readys agree on a root and ≥ N−2f matching Echos are in hand."""
        if self.decided or self.fault:
            return Step()
        n, f = self.netinfo.num_nodes(), self.netinfo.num_faulty()
        # sorted: with Byzantine equivocation two roots can in principle
        # clear both thresholds in the same crank at small n — set
        # iteration order must not pick which one decodes
        roots = {r for r in self.readys.values()}
        for root in sorted(roots):
            if self._count_readys(root) < 2 * f + 1:
                continue
            if self._count_echos(root) < self.data_shard_num:
                continue
            # reconstruct from the echo shards
            shards: list = [None] * n
            for nid, proof in self.echos.items():
                if proof.root_hash == root:
                    shards[proof.index] = proof.value
            # Byzantine senders may echo duplicate SLOTS, so the sender
            # count above can exceed the distinct-slot count — too few
            # distinct slots stays RETRIABLE (honest echoes still coming)
            if sum(s is not None for s in shards) < self.data_shard_num:
                continue
            try:
                full = self.coder.reconstruct_np(shards, device=self.device)
            except ValueError:
                # ≥ k distinct committed slots in hand, yet reconstruction
                # is impossible: a PERMANENT commitment defect (the
                # proposer Merkle-committed odd/inconsistent-length
                # shards).  Treating it as retriable would livelock every
                # honest node against such a proposer; fault it like the
                # root-mismatch case.
                self.fault = True
                return Step.from_fault(
                    self.proposer_id, FaultKind.InvalidProof
                )
            # re-encode & verify the root (defends against a faulty proposer
            # whose shards don't form a consistent codeword)
            tree = MerkleTree.from_vec(full)
            if tree.root_hash() != root:
                self.fault = True
                return Step.from_fault(
                    self.proposer_id, FaultKind.InvalidProof
                )
            value = _unframe_value(
                b"".join(full[: self.data_shard_num])
            )
            if value is None:
                self.fault = True
                return Step.from_fault(
                    self.proposer_id, FaultKind.InvalidProof
                )
            self.decided = True
            self.output = value
            return Step.from_output(value)
        return Step()


# -- framing ----------------------------------------------------------------


def _frame_value(value: bytes, data_shards: int) -> np.ndarray:
    """value → (data_shards, B) uint8: 4-byte length prefix + value + zeros.

    The shard length rounds up to EVEN, matching the array-mode
    ``parallel.rbc.frame_values``: the GF(2^16) coder (networks beyond the
    reference's 256-shard limit) works in u16 symbols, and an odd length
    would fail its encode."""
    framed = len(value).to_bytes(4, "big") + value
    shard_len = max(2, -(-len(framed) // data_shards))
    shard_len += shard_len % 2
    framed = framed.ljust(data_shards * shard_len, b"\0")
    return np.frombuffer(framed, dtype=np.uint8).reshape(data_shards, shard_len)


def _encode_value(coder, value: bytes, device="cuda"):
    """Frame + RS-encode ``value`` into ONE contiguous shard buffer.

    Returns ``(shards, leaves)``: ``shards`` is the (total, B) uint8 array
    (data rows framed in place, parity written into the tail by
    ``encode_into``), ``leaves`` are memoryview slices of a SINGLE immutable
    bytes snapshot of it.  The Merkle tree hashes the array rows directly
    and the per-peer proofs carry the shared slices, so the proposer path
    copies each payload byte O(1) times total — the old path round-tripped
    every shard through ``tobytes()`` and re-materialized it per peer."""
    k = coder.data_shards
    framed_len = 4 + len(value)
    shard_len = max(2, -(-framed_len // k))
    shard_len += shard_len % 2
    # empty + explicit tail-zero, not zeros: calloc hands back fresh
    # lazily-mapped pages every call, and the page faults land on the
    # encode/hash steps that first touch them — malloc reuse keeps the
    # hot loop on warm pages.  Parity rows are fully overwritten below.
    shards = np.empty((coder.total_shards, shard_len), dtype=np.uint8)
    flat = shards[:k].reshape(-1)
    flat[:4] = np.frombuffer(len(value).to_bytes(4, "big"), dtype=np.uint8)
    if value:
        flat[4:framed_len] = np.frombuffer(value, dtype=np.uint8)
    flat[framed_len:] = 0
    coder.encode_into(shards, device=device)
    buf = shards.tobytes()  # the one immutable snapshot all slices share
    mv = memoryview(buf)
    leaves = [
        mv[i * shard_len:(i + 1) * shard_len]
        for i in range(coder.total_shards)
    ]
    return shards, leaves


def _unframe_value(framed: bytes) -> Optional[bytes]:
    if len(framed) < 4:
        return None
    length = int.from_bytes(framed[:4], "big")
    if 4 + length > len(framed):
        return None
    return framed[4 : 4 + length]

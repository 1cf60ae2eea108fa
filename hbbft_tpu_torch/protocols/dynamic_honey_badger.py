"""Dynamic HoneyBadger's committed types: changes, votes, key-gen messages.

The port's copy of the types of the JAX package's
``protocols/dynamic_honey_badger.py`` that the array-mode driver
``parallel/dhb.py`` uses (reference: ``src/dynamic_honey_badger/`` —
``change.rs``, ``votes.rs``, ``batch.rs``, the ``KeyGenMessage::{Part,
Ack}`` payloads, ``InternalContrib`` and ``JoinPlan``).  The object-mode
``DynamicHoneyBadger``, ``DynamicHoneyBadgerBuilder`` and the messages
are not ported.

Every value here is bytes on the wire, because it rides inside a
TPKE-encrypted, RBC-sharded contribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
from hbbft_tpu_torch.protocols.sync_key_gen import Ack, Part

NodeId = Hashable


# -- Change / ChangeState (reference: change.rs) -----------------------------


@dataclass(frozen=True)
class Change:
    """``Change::NodeChange(new validator key map)`` or
    ``Change::EncryptionSchedule(schedule)``."""

    kind: str  # "nodes" | "encryption_schedule"
    new_keys: Tuple[Tuple[NodeId, bytes], ...] = ()  # sorted (id, pk bytes)
    schedule: Tuple = ()

    @classmethod
    def node_change(cls, pub_keys: Dict[NodeId, tc.PublicKey]) -> "Change":
        return cls(
            "nodes",
            tuple(
                sorted(
                    ((nid, pk.to_bytes()) for nid, pk in pub_keys.items()),
                    key=lambda kv: repr(kv[0]),
                )
            ),
        )

    @classmethod
    def encryption_schedule(cls, es: EncryptionSchedule) -> "Change":
        return cls("encryption_schedule", schedule=(es.kind, es.a, es.b))

    def key_map(self) -> Dict[NodeId, tc.PublicKey]:
        return {nid: tc.PublicKey.from_bytes(pk) for nid, pk in self.new_keys}

    def to_bytes(self) -> bytes:
        if self.kind == "nodes":
            out = b"\x01" + wire.u32(len(self.new_keys))
            for nid, pk in self.new_keys:
                out += wire.node_id(nid) + wire.blob(pk)
            return out
        k, a, b = self.schedule
        return b"\x02" + wire.blob(k.encode()) + wire.u32(a) + wire.u32(b)

    @classmethod
    def read(cls, r: wire.Reader) -> "Change":
        tag = r.take(1)
        if tag == b"\x01":
            n = r.u32()
            if n > 100_000:
                raise ValueError("absurd validator count")
            keys = tuple((wire.read_node_id(r), r.blob()) for _ in range(n))
            return cls("nodes", keys)
        if tag == b"\x02":
            k = r.blob().decode()
            return cls("encryption_schedule", schedule=(k, r.u32(), r.u32()))
        raise ValueError("bad change tag")


@dataclass(frozen=True)
class ChangeState:
    """None / InProgress(change) / Complete(change)."""

    state: str  # "none" | "in_progress" | "complete"
    change: Optional[Change] = None

    @classmethod
    def none(cls):
        return cls("none")

    @classmethod
    def in_progress(cls, change: Change):
        return cls("in_progress", change)

    @classmethod
    def complete(cls, change: Change):
        return cls("complete", change)


# -- votes (reference: votes.rs) --------------------------------------------


@dataclass(frozen=True)
class SignedVote:
    voter: NodeId
    era: int
    num: int  # per-voter sequence number; later votes supersede earlier
    change: Change
    sig: tc.Signature

    def signed_payload(self) -> bytes:
        return _vote_payload(self.voter, self.era, self.num, self.change)

    def to_bytes(self) -> bytes:
        return (
            wire.node_id(self.voter)
            + wire.u64(self.era)
            + wire.u64(self.num)
            + wire.blob(self.change.to_bytes())
            + wire.signature(self.sig)
        )

    @classmethod
    def read(cls, r: wire.Reader) -> "SignedVote":
        voter = wire.read_node_id(r)
        era = r.u64()
        num = r.u64()
        change = Change.read(wire.Reader(r.blob()))
        sig = wire.read_signature(r)
        return cls(voter, era, num, change, sig)


def _vote_payload(voter: NodeId, era: int, num: int, change: Change) -> bytes:
    return (
        b"HBBFT-DHB-VOTE"
        + wire.node_id(voter)
        + wire.u64(era)
        + wire.u64(num)
        + change.to_bytes()
    )


class VoteCounter:
    """Reference: ``votes.rs :: VoteCounter`` — committed votes decide."""

    def __init__(self, era: int):
        self.era = era
        self.pending: Dict[NodeId, SignedVote] = {}
        self.committed: Dict[NodeId, SignedVote] = {}

    def add_pending(self, vote: SignedVote) -> None:
        cur = self.pending.get(vote.voter)
        if cur is None or cur.num < vote.num:
            self.pending[vote.voter] = vote

    def add_committed(self, vote: SignedVote) -> None:
        cur = self.committed.get(vote.voter)
        if cur is None or cur.num < vote.num:
            self.committed[vote.voter] = vote
        self.pending.pop(vote.voter, None)

    def pending_votes(self) -> List[SignedVote]:
        return sorted(self.pending.values(), key=lambda v: repr(v.voter))

    def compute_winner(self, validators: List[NodeId]) -> Optional[Change]:
        """The change voted for by a strict majority of current validators."""
        tally: Dict[Change, int] = {}
        for nid in validators:
            v = self.committed.get(nid)
            if v is not None:
                tally[v.change] = tally.get(v.change, 0) + 1
        for change, count in sorted(
            tally.items(), key=lambda kv: repr(kv[0])
        ):
            if count * 2 > len(validators):
                return change
        return None


# -- key-gen messages --------------------------------------------------------


def _keygen_payload(era: int, sender: NodeId, kind: str, payload: bytes) -> bytes:
    """Signing preimage for key-gen messages.  Every field is length-framed
    so the kind/payload boundary is not malleable under a valid signature."""
    return (
        b"HBBFT-DHB-KEYGEN"
        + wire.u64(era)
        + wire.node_id(sender)
        + wire.blob(kind.encode())
        + wire.blob(payload)
    )


@dataclass(frozen=True)
class SignedKeyGenMsg:
    era: int
    sender: NodeId
    kind: str  # "part" | "ack"
    payload: bytes  # serialized Part or Ack
    sig: tc.Signature

    def signed_payload(self) -> bytes:
        return _keygen_payload(self.era, self.sender, self.kind, self.payload)

    def to_bytes(self) -> bytes:
        return (
            wire.u64(self.era)
            + wire.node_id(self.sender)
            + wire.blob(self.kind.encode())
            + wire.blob(self.payload)
            + wire.signature(self.sig)
        )

    @classmethod
    def read(cls, r: wire.Reader) -> "SignedKeyGenMsg":
        era = r.u64()
        sender = wire.read_node_id(r)
        kind = r.blob().decode()
        payload = r.blob()
        sig = wire.read_signature(r)
        return cls(era, sender, kind, payload, sig)


def ser_part(part: Part) -> bytes:
    out = wire.commitment_bivar(part.commitment)
    out += wire.u32(len(part.rows))
    for ct in part.rows:
        out += wire.ciphertext(ct)
    return out


def de_part(data: bytes) -> Part:
    r = wire.Reader(data)
    com = wire.read_commitment_bivar(r)
    n = r.u32()
    if n > 100_000:
        raise ValueError("absurd row count")
    rows = tuple(wire.read_ciphertext(r) for _ in range(n))
    return Part(com, rows)


def ser_ack(ack: Ack) -> bytes:
    out = wire.u32(ack.proposer_index) + wire.u32(len(ack.values))
    for ct in ack.values:
        out += wire.ciphertext(ct)
    return out


def de_ack(data: bytes) -> Ack:
    r = wire.Reader(data)
    proposer = r.u32()
    n = r.u32()
    if n > 100_000:
        raise ValueError("absurd value count")
    values = tuple(wire.read_ciphertext(r) for _ in range(n))
    return Ack(proposer, values)


# -- internal contribution ---------------------------------------------------


@dataclass
class InternalContrib:
    """What actually rides through HoneyBadger each epoch.

    Reference: ``dynamic_honey_badger.rs :: InternalContrib`` — user payload
    + pending votes + observed signed key-gen messages.
    """

    contribution: bytes
    votes: List[SignedVote]
    key_gen_msgs: List[SignedKeyGenMsg]

    def to_bytes(self) -> bytes:
        out = wire.blob(self.contribution)
        out += wire.u32(len(self.votes))
        for v in self.votes:
            out += wire.blob(v.to_bytes())
        out += wire.u32(len(self.key_gen_msgs))
        for m in self.key_gen_msgs:
            out += wire.blob(m.to_bytes())
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "InternalContrib":
        r = wire.Reader(data)
        contribution = r.blob()
        nv = r.u32()
        if nv > 100_000:
            raise ValueError("absurd vote count")
        votes = [SignedVote.read(wire.Reader(r.blob())) for _ in range(nv)]
        nk = r.u32()
        if nk > 100_000:
            raise ValueError("absurd keygen count")
        kgs = [SignedKeyGenMsg.read(wire.Reader(r.blob())) for _ in range(nk)]
        return cls(contribution, votes, kgs)


# -- inputs / outputs --------------------------------------------------------


@dataclass(frozen=True)
class DhbBatch:
    """Reference: ``dynamic_honey_badger/batch.rs``."""

    era: int
    epoch: int
    contributions: Tuple[Tuple[NodeId, bytes], ...]
    change: ChangeState

    def contributions_map(self) -> Dict[NodeId, bytes]:
        return dict(self.contributions)


@dataclass(frozen=True)
class JoinPlan:
    """Everything a node needs to join at the start of ``era``.

    Reference: ``dynamic_honey_badger.rs :: JoinPlan``.
    """

    era: int
    pub_key_set_bytes: bytes
    pub_keys: Tuple[Tuple[NodeId, bytes], ...]
    encryption_schedule: Tuple

    def public_key_set(self) -> tc.PublicKeySet:
        from hbbft_tpu_torch.crypto import bls12_381 as bls

        data = self.pub_key_set_bytes
        pts = [
            bls.g1_from_bytes(data[i : i + 97])
            for i in range(0, len(data), 97)
        ]
        return tc.PublicKeySet(tc.Commitment(pts))

    def key_map(self) -> Dict[NodeId, tc.PublicKey]:
        return {nid: tc.PublicKey.from_bytes(pk) for nid, pk in self.pub_keys}

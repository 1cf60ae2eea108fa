"""Dynamic HoneyBadger: validator-set changes via consensus-committed DKG.

Reference: ``src/dynamic_honey_badger/`` — ``dynamic_honey_badger.rs``,
``votes.rs`` (``VoteCounter``/``SignedVote``), ``change.rs`` (``Change``,
``ChangeState``), ``batch.rs``, plus the ``KeyGenMessage::{Part, Ack}``
plumbing, and ``JoinPlan`` for nodes joining at an era boundary.

Mechanism: every epoch, each validator's contribution is an
``InternalContrib`` — the user payload piggy-backed with its pending signed
votes and any signed key-gen messages it has observed.  Because these ride
through HoneyBadger, **all correct nodes process the same votes and DKG
messages in the same order** — exactly the external agreement ``SyncKeyGen``
requires.  When a ``Change`` gains a majority of validator votes it becomes
``ChangeState.InProgress``; the new validator set runs the DKG (candidates
send their ``Part``/``Ack`` as signed direct messages, validators commit
them); when the DKG is ready the era rotates: fresh ``NetworkInfo`` with the
new ``PublicKeySet`` and shares, a fresh inner ``HoneyBadger``, and the batch
reports ``ChangeState.Complete``.

Era boundaries are the join points: ``join_plan()`` packages everything a
new node needs to start at the next era.

The port's copy of the JAX package's module.  The committed types
(``Change``, votes, key-gen messages, ``InternalContrib``, ``DhbBatch``,
``JoinPlan``) are also what the array-mode driver ``parallel/dhb.py``
uses.  ``device`` (the builder's ``.device()``, default ``"cuda"``,
raising without a card) goes to the inner ``HoneyBadger`` of every era and
to each ``SyncKeyGen``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Set, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.protocols.honey_badger import (
    Batch as HbBatch,
    EncryptionSchedule,
    HoneyBadger,
)
from hbbft_tpu_torch.protocols.sync_key_gen import Ack, Part, SyncKeyGen
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

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
# hblint: disable=wire-unregistered (never travels bare: always inside
# the registered KeyGenWrap envelope, whose codec — enc_skg/dec_skg in
# wire._lazy_register — covers this class field-for-field)
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
class UserInput:
    contribution: bytes


@dataclass(frozen=True)
class ChangeInput:
    change: Change


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


# -- messages ---------------------------------------------------------------


@dataclass(frozen=True)
class HbWrap:
    era: int
    msg: object


@dataclass(frozen=True)
class KeyGenWrap:
    era: int
    msg: SignedKeyGenMsg


class DynamicHoneyBadgerBuilder:
    """Reference: ``dynamic_honey_badger/builder.rs`` — the same typed knobs
    (era, rng, encryption schedule, epoch window), and the port's
    ``device``."""

    def __init__(self, netinfo: NetworkInfo, secret_key: tc.SecretKey):
        self._netinfo = netinfo
        self._secret_key = secret_key
        self._era = 0
        self._rng: Optional[random.Random] = None
        self._schedule: Optional[EncryptionSchedule] = None
        self._max_future_epochs = 3
        self._device = "cuda"

    def era(self, era: int) -> "DynamicHoneyBadgerBuilder":
        self._era = era
        return self

    def rng(self, rng: random.Random) -> "DynamicHoneyBadgerBuilder":
        self._rng = rng
        return self

    def encryption_schedule(self, s: EncryptionSchedule) -> "DynamicHoneyBadgerBuilder":
        self._schedule = s
        return self

    def max_future_epochs(self, n: int) -> "DynamicHoneyBadgerBuilder":
        self._max_future_epochs = n
        return self

    def device(self, device) -> "DynamicHoneyBadgerBuilder":
        """Where the crypto batches, the DKG's commitment checks and the
        ``device`` erasure backend run (default ``"cuda"``; ``build``
        raises without a card)."""
        self._device = device
        return self

    def build(self) -> "DynamicHoneyBadger":
        return DynamicHoneyBadger(
            self._netinfo,
            self._secret_key,
            era=self._era,
            rng=self._rng,
            encryption_schedule=self._schedule,
            max_future_epochs=self._max_future_epochs,
            device=self._device,
        )


class DynamicHoneyBadger(ConsensusProtocol):
    """Reference: ``dynamic_honey_badger.rs :: DynamicHoneyBadger<C, N>``."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        secret_key: tc.SecretKey,
        era: int = 0,
        rng: Optional[random.Random] = None,
        encryption_schedule: Optional[EncryptionSchedule] = None,
        max_future_epochs: int = 3,
        device="cuda",
    ):
        self.netinfo = netinfo
        self.device = resolve_device(device)
        self.secret_key = secret_key
        self.era = era
        self.rng = rng or random.Random(0)
        self.encryption_schedule = encryption_schedule or EncryptionSchedule.always()
        self.max_future_epochs = max_future_epochs
        self.vote_counter = VoteCounter(era)
        self.change_state: ChangeState = ChangeState.none()
        self.key_gen: Optional[SyncKeyGen] = None
        self.key_gen_change: Optional[Change] = None
        self.pending_kg: List[SignedKeyGenMsg] = []
        self.kg_seen: Set[bytes] = set()
        # the consensus-committed DKG transcript of the in-progress change
        # (every signature-valid key-gen message, in committed order) and,
        # after a node-change rotation, the completed era's transcript —
        # what a snapshot-joining node replays through its own SyncKeyGen
        # to decrypt its rows and derive its secret key share with zero
        # epoch replay
        self.kg_transcript: List[SignedKeyGenMsg] = []
        self.last_join_transcript: Tuple[SignedKeyGenMsg, ...] = ()
        self.vote_num = 0
        # next-era message buffer — budgeted PER SENDER (overload
        # defense): the old shared 100k cap let one Byzantine peer fill
        # the whole buffer (uncounted) and starve honest next-era
        # traffic.  Now each sender owns a slice; overflow drops ONLY
        # that sender's messages, counted in ``future_era_drops``.
        self.future_era: List[Tuple[NodeId, object]] = []
        self.future_era_cap_per_sender = 4096
        self._future_era_counts: Dict[NodeId, int] = {}
        self.future_era_drops: Dict[NodeId, int] = {}
        # what to propose when only the DKG needs the epoch to advance: a
        # wrapper (QueueingHoneyBadger) installs a provider that returns a
        # REAL contribution so throughput doesn't stall during a DKG
        self.contribution_provider: Optional[Any] = None
        self.empty_contribution: bytes = b""
        self.era_has_batches = False
        # epoch-pipelined runtimes set this (see HoneyBadger.defer_decrypt);
        # it must survive era rotation, so it lives here and _make_hb
        # stamps every inner HoneyBadger with it
        self.defer_decrypt_verify = False
        self.hb = self._make_hb()

    @classmethod
    def builder(cls, netinfo: NetworkInfo, secret_key: tc.SecretKey) -> "DynamicHoneyBadgerBuilder":
        return DynamicHoneyBadgerBuilder(netinfo, secret_key)

    @classmethod
    def from_join_plan(
        cls,
        our_id: NodeId,
        secret_key: tc.SecretKey,
        plan: JoinPlan,
        rng: Optional[random.Random] = None,
        secret_key_share: Optional[tc.SecretKeyShare] = None,
        device="cuda",
    ) -> "DynamicHoneyBadger":
        """Construct a node starting at an era boundary.

        Without ``secret_key_share`` the node is an observer (the
        reference's JoinPlan semantics); with one — derived by replaying
        the era's committed DKG transcript through ``SyncKeyGen`` — it is a
        full validator from epoch 0 of the plan's era."""
        netinfo = NetworkInfo(
            our_id=our_id,
            public_keys=plan.key_map(),
            public_key_set=plan.public_key_set(),
            secret_key_share=secret_key_share,
            secret_key=secret_key,
        )
        k, a, b = plan.encryption_schedule
        return cls(
            netinfo,
            secret_key,
            era=plan.era,
            rng=rng,
            encryption_schedule=EncryptionSchedule(k, a, b),
            device=device,
        )

    def _make_hb(self) -> HoneyBadger:
        hb = HoneyBadger(
            self.netinfo,
            session_id=b"dhb-era-" + wire.u64(self.era),
            max_future_epochs=self.max_future_epochs,
            encryption_schedule=self.encryption_schedule,
            rng=random.Random(self.rng.getrandbits(64)),
            device=self.device,
        )
        hb.defer_decrypt = self.defer_decrypt_verify
        return hb

    # -- pickling (snapshot/restore support) ---------------------------------

    def __getstate__(self):
        # contribution_provider is a closure installed by wrappers
        # (QueueingHoneyBadger) — drop it; the wrapper reinstalls on restore
        d = self.__dict__.copy()
        d["contribution_provider"] = None
        return d

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return False

    def is_validator(self) -> bool:
        return self.netinfo.is_validator()

    def handle_input(self, input) -> Step:
        if isinstance(input, UserInput):
            return self.propose(input.contribution)
        if isinstance(input, ChangeInput):
            return self.vote_for(input.change)
        raise TypeError(f"unknown DHB input {input!r}")

    def propose(self, contribution: bytes) -> Step:
        """Wrap the user payload with pending votes + key-gen messages and
        propose it into the inner HoneyBadger."""
        if not self.is_validator():
            return Step()
        contrib = InternalContrib(
            contribution=bytes(contribution),
            votes=self.vote_counter.pending_votes(),
            key_gen_msgs=list(self.pending_kg),
        )
        inner = self.hb.propose(contrib.to_bytes())
        return self._process_hb_step(inner)

    def propose_ahead(self, contribution: bytes, offset: int) -> Step:
        """Propose into epoch ``hb.epoch + offset`` of the CURRENT era —
        the epoch-pipelining entry (``offset=0`` is plain ``propose``).

        The wrapped payload carries this node's pending votes/key-gen
        messages exactly like a current-epoch proposal; if the era rotates
        before the future epoch completes, its in-flight state dies with
        the old inner HoneyBadger and the transactions simply get
        re-proposed in the new era (they leave the queue only on commit).
        """
        if not self.is_validator():
            return Step()
        contrib = InternalContrib(
            contribution=bytes(contribution),
            votes=self.vote_counter.pending_votes(),
            key_gen_msgs=list(self.pending_kg),
        )
        inner = self.hb.propose_into(
            self.hb.epoch + offset, contrib.to_bytes()
        )
        return self._process_hb_step(inner)

    def has_deferred(self) -> bool:
        return self.hb.has_deferred()

    def resolve_deferred(self) -> Step:
        """Drain the inner HoneyBadger's parked decrypt verifications
        (see ``HoneyBadger.resolve_deferred``), with batch/era processing
        applied to whatever completes."""
        return self._process_hb_step(self.hb.resolve_deferred())

    def vote_for(self, change: Change) -> Step:
        """Sign and queue a vote (committed via a later contribution).

        Reference: ``DynamicHoneyBadger::vote_for``.
        """
        if not self.is_validator():
            return Step()
        self.vote_num += 1
        payload = _vote_payload(self.our_id(), self.era, self.vote_num, change)
        vote = SignedVote(
            self.our_id(),
            self.era,
            self.vote_num,
            change,
            self.secret_key.sign(payload),
        )
        self.vote_counter.add_pending(vote)
        return Step()

    def vote_to_add(self, node_id: NodeId, pub_key: tc.PublicKey) -> Step:
        keys = dict(self.netinfo.public_key_map())
        keys[node_id] = pub_key
        return self.vote_for(Change.node_change(keys))

    def vote_to_remove(self, node_id: NodeId) -> Step:
        keys = dict(self.netinfo.public_key_map())
        keys.pop(node_id, None)
        return self.vote_for(Change.node_change(keys))

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if isinstance(message, HbWrap):
            if message.era < self.era:
                return Step()
            if message.era > self.era:
                if message.era > self.era + 1:
                    return Step.from_fault(
                        sender_id, FaultKind.UnexpectedHbMessage
                    )
                count = self._future_era_counts.get(sender_id, 0)
                if count >= self.future_era_cap_per_sender:
                    # counted drop of the SPAMMER's overflow only —
                    # other senders' next-era slices are untouched
                    self.future_era_drops[sender_id] = (
                        self.future_era_drops.get(sender_id, 0) + 1
                    )
                    return Step.from_fault(
                        sender_id, FaultKind.FutureEpochFlood
                    )
                self._future_era_counts[sender_id] = count + 1
                self.future_era.append((sender_id, message))
                return Step()
            inner = self.hb.handle_message(sender_id, message.msg)
            return self._process_hb_step(inner)
        if isinstance(message, KeyGenWrap):
            if message.era != self.era:
                return Step()
            return self._observe_key_gen_msg(sender_id, message.msg)
        raise TypeError(f"unknown DHB message {message!r}")

    # -- key-gen message flow ------------------------------------------------

    def _kg_key_map(self) -> Dict[NodeId, tc.PublicKey]:
        """Who may sign key-gen messages: current validators + candidates."""
        keys = dict(self.netinfo.public_key_map())
        if self.key_gen_change is not None:
            keys.update(self.key_gen_change.key_map())
        return keys

    def _observe_key_gen_msg(self, sender_id: NodeId, skg: SignedKeyGenMsg) -> Step:
        """A validator observed a signed Part/Ack: queue it for inclusion in
        our next contribution (after signature screening)."""
        key = skg.to_bytes()
        if key in self.kg_seen:
            return Step()
        if skg.era != self.era or skg.sender != sender_id:
            return Step.from_fault(sender_id, FaultKind.InvalidKeyGenMessage)
        pk = self._kg_key_map().get(skg.sender)
        if pk is None or not pk.verify(skg.sig, skg.signed_payload()):
            return Step.from_fault(sender_id, FaultKind.InvalidKeyGenMessage)
        self.kg_seen.add(key)
        self.pending_kg.append(skg)
        return Step()

    def _send_key_gen_msg(self, kind: str, payload: bytes) -> Step:
        skg = SignedKeyGenMsg(
            era=self.era,
            sender=self.our_id(),
            kind=kind,
            payload=payload,
            sig=self.secret_key.sign(
                _keygen_payload(self.era, self.our_id(), kind, payload)
            ),
        )
        self.kg_seen.add(skg.to_bytes())
        self.pending_kg.append(skg)
        step = Step()
        step.send_all(KeyGenWrap(self.era, skg))
        return step

    # -- batch processing ----------------------------------------------------

    def _process_hb_step(self, inner: Step) -> Step:
        step = inner.map(lambda m: HbWrap(self.era, m))
        batches = step.output
        step.output = []
        for hb_batch in batches:
            step.extend(self._process_batch(hb_batch))
        return step

    def _process_batch(self, hb_batch: HbBatch) -> Step:
        step = Step()
        contributions: List[Tuple[NodeId, bytes]] = []
        all_kg: List[Tuple[NodeId, SignedKeyGenMsg]] = []
        for proposer, payload in hb_batch.contributions:
            try:
                contrib = InternalContrib.from_bytes(payload)
            except (ValueError, TypeError, UnicodeDecodeError):
                step.fault(proposer, FaultKind.BatchDeserializationFailed)
                continue
            contributions.append((proposer, contrib.contribution))
            for vote in contrib.votes:
                step.extend(self._commit_vote(proposer, vote))
            for skg in contrib.key_gen_msgs:
                all_kg.append((proposer, skg))
        # winner check happens before applying this batch's keygen messages:
        # a fresh InProgress change means the DKG starts with this batch
        if self.change_state.state == "none":
            winner = self.vote_counter.compute_winner(self.netinfo.all_ids())
            if winner is not None:
                step.extend(self._start_change(winner))
        # committed key-gen messages, in deterministic batch order
        for proposer, skg in all_kg:
            step.extend(self._apply_committed_kg(proposer, skg))
        # this era now has a completed epoch (set BEFORE rotation: _rotate
        # resets it for the new era, and replayed new-era batches re-set it)
        era_of_batch = self.era
        epoch_of_batch = hb_batch.epoch
        self.era_has_batches = True
        # era rotation check: if this batch completed the change, the batch
        # itself reports Complete (reference batch semantics)
        rot_step, completed = self._try_rotate_era()
        batch_change = (
            ChangeState.complete(completed)
            if completed is not None
            else self.change_state
        )
        batch = DhbBatch(
            era=era_of_batch,
            epoch=epoch_of_batch,
            contributions=tuple(contributions),
            change=batch_change,
        )
        step.output.append(batch)
        step.extend(rot_step)
        # keep the pipeline moving while a DKG is pending
        if (
            self.key_gen is not None
            and self.is_validator()
            and not self.hb.has_input.get(self.hb.epoch)
        ):
            contrib = (
                self.contribution_provider()
                if self.contribution_provider is not None
                else self.empty_contribution
            )
            step.extend(self.propose(contrib))
        return step

    def _commit_vote(self, proposer: NodeId, vote: SignedVote) -> Step:
        if vote.era != self.era:
            return Step()
        if not self.netinfo.is_node_validator(vote.voter):
            return Step.from_fault(proposer, FaultKind.InvalidVoteSignature)
        pk = self.netinfo.public_key(vote.voter)
        if pk is None or not pk.verify(vote.sig, vote.signed_payload()):
            return Step.from_fault(proposer, FaultKind.InvalidVoteSignature)
        self.vote_counter.add_committed(vote)
        return Step()

    def _start_change(self, change: Change) -> Step:
        self.change_state = ChangeState.in_progress(change)
        step = Step()
        if change.kind == "encryption_schedule":
            # no DKG needed: rotate immediately at the next batch boundary
            return step
        # start the DKG among the new validator set
        self.key_gen_change = change
        self.kg_transcript = []
        new_keys = change.key_map()
        threshold = (len(new_keys) - 1) // 3
        self.key_gen = SyncKeyGen(
            self.our_id(),
            self.secret_key,
            new_keys,
            threshold,
            random.Random(self.rng.getrandbits(64)),
            device=self.device,
        )
        if self.our_id() in new_keys:
            part = self.key_gen.generate_part()
            step.extend(self._send_key_gen_msg("part", ser_part(part)))
        return step

    def _apply_committed_kg(self, proposer: NodeId, skg: SignedKeyGenMsg) -> Step:
        if self.key_gen is None or skg.era != self.era:
            return Step()
        # committed: no need to re-propose it ourselves anymore
        key = skg.to_bytes()
        self.kg_seen.add(key)
        self.pending_kg = [m for m in self.pending_kg if m.to_bytes() != key]
        pk = self._kg_key_map().get(skg.sender)
        if pk is None or not pk.verify(skg.sig, skg.signed_payload()):
            return Step.from_fault(proposer, FaultKind.InvalidKeyGenMessage)
        # transcript entry: every signature-valid committed message, in
        # committed order — a snapshot joiner replaying these through its
        # own SyncKeyGen reaches the identical complete-dealer set (the
        # messages below that SyncKeyGen rejects, it rejects identically)
        self.kg_transcript.append(skg)
        step = Step()
        try:
            if skg.kind == "part":
                outcome = self.key_gen.handle_part(skg.sender, de_part(skg.payload))
                if outcome.fault is not None:
                    return step.fault(skg.sender, outcome.fault)
                if outcome.ack is not None:
                    step.extend(
                        self._send_key_gen_msg("ack", ser_ack(outcome.ack))
                    )
            elif skg.kind == "ack":
                outcome = self.key_gen.handle_ack(skg.sender, de_ack(skg.payload))
                if outcome.fault is not None:
                    return step.fault(skg.sender, outcome.fault)
            else:
                # the signature covers the framed kind, so a bad kind is the
                # SIGNER's doing — but a malformed frame could only have come
                # from the proposer; blame whoever actually authored it
                return step.fault(skg.sender, FaultKind.InvalidKeyGenMessage)
        except ValueError:
            return step.fault(skg.sender, FaultKind.InvalidKeyGenMessage)
        return step

    # -- era rotation --------------------------------------------------------

    def _try_rotate_era(self) -> Tuple[Step, Optional[Change]]:
        """Returns (step, completed_change) — the change is not None iff the
        era rotated now."""
        if self.change_state.state != "in_progress":
            return Step(), None
        change = self.change_state.change
        if change.kind == "encryption_schedule":
            k, a, b = change.schedule
            self.encryption_schedule = EncryptionSchedule(k, a, b)
            return self._rotate(change, self.netinfo), change
        assert self.key_gen is not None
        if not self.key_gen.is_ready():
            return Step(), None
        pub_key_set, sk_share = self.key_gen.generate()
        new_keys = change.key_map()
        netinfo = NetworkInfo(
            our_id=self.our_id(),
            public_keys=new_keys,
            public_key_set=pub_key_set,
            secret_key_share=sk_share,
            secret_key=self.secret_key,
        )
        return self._rotate(change, netinfo), change

    def _rotate(self, change: Change, netinfo: NetworkInfo) -> Step:
        self.netinfo = netinfo
        self.era += 1
        self.era_has_batches = False
        self.change_state = ChangeState.none()
        self.vote_counter = VoteCounter(self.era)
        # a node-change era carries its DKG transcript to the boundary:
        # join_plan() + last_join_transcript is the complete snapshot a
        # joiner needs (an encryption-schedule rotation keeps the old key
        # material, so its transcript is empty and joiners fall back to
        # config-derived shares)
        self.last_join_transcript = (
            tuple(self.kg_transcript) if change.kind == "nodes" else ()
        )
        self.kg_transcript = []
        self.key_gen = None
        self.key_gen_change = None
        self.pending_kg = []
        self.kg_seen = set()
        self.vote_num = 0
        self.hb = self._make_hb()
        step = Step()
        # replay buffered next-era messages
        future, self.future_era = self.future_era, []
        self._future_era_counts.clear()
        for sender, msg in future:
            if msg.era == self.era:
                step.extend(self.handle_message(sender, msg))
        return step

    # -- join plan -----------------------------------------------------------

    def join_plan(self) -> JoinPlan:
        """Information for a node joining at the CURRENT era boundary.

        Only valid while no epoch of this era has completed: a joiner cannot
        replay epochs whose messages it never received, so it must observe
        the era from its very start (the reference produces JoinPlans only
        at era rotation for the same reason).  Raises mid-era.
        """
        if self.era_has_batches:
            raise ValueError(
                "join_plan() is only valid at an era boundary (epochs of "
                "this era already completed; rotate the era first)"
            )
        from hbbft_tpu_torch.crypto import bls12_381 as bls

        pks = self.netinfo.public_key_set()
        return JoinPlan(
            era=self.era,
            pub_key_set_bytes=b"".join(
                bls.g1_to_bytes(p) for p in pks.commitment.points
            ),
            pub_keys=tuple(
                sorted(
                    (
                        (nid, pk.to_bytes())
                        for nid, pk in self.netinfo.public_key_map().items()
                    ),
                    key=lambda kv: repr(kv[0]),
                )
            ),
            encryption_schedule=(
                self.encryption_schedule.kind,
                self.encryption_schedule.a,
                self.encryption_schedule.b,
            ),
        )

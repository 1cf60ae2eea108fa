"""Verifiable information dispersal: availability decoupled from ordering.

The DispersedLedger (NSDI '22) construction on top of this stack: instead
of reliable-broadcasting every full contribution through the epoch's
subset (classic HoneyBadger, where one bandwidth-starved node drags every
commit), a proposer **disperses** its contribution — RS-encodes it with
the same coder/framing as RBC, ships each node exactly ONE shard plus its
Merkle proof, and collects ``n − f`` signed availability votes into a
*retrievability certificate*.  Consensus then orders only the constant-size
``(root, cert)`` commitment; the payload is **retrieved** lazily (fetch any
``k = n − 2f`` shards, reconstruct through the LRU'd Gauss–Jordan pattern
caches, re-verify against the committed root) off the ordering critical
path — see :mod:`hbbft_tpu_torch.net.retrieve` for the fetch/reconstruct service.

Protocol pieces, all sans-I/O:

- :class:`VidDisperse` / :class:`VidVote` ride the normal SenderQueue
  message path (era-keyed, see ``sender_queue.message_key``);
  :class:`VidRetrieve` / :class:`VidShard` are driver-level messages the
  node runtime routes directly (retrieval is a network service, not a
  consensus round).
- :class:`Disperser` holds the per-node dispersal state: proposer-side
  vote collection and receiver-side shard storage + voting.
- :class:`VidQueueingHoneyBadger` is QHB in VID mode: ``_maybe_propose``
  disperses first and proposes the ``VID1``-prefixed commitment once the
  cert completes; committed epochs surface as :class:`VidQhbBatch`
  (raw ordered payloads, **no** ``all_txs`` — transactions exist only
  after retrieval).  Plain (non-``VID1``) contributions — the empty
  keep-alive and the DKG provider's — decode inline as before, so mixed
  batches are first-class.

Trust model: a cert proves ``n − f`` nodes hold proof-valid shards under
``root``, of which ``≥ n − 2f = k`` are honest — enough to reconstruct.
A Byzantine proposer can still commit a root whose leaves are NOT an RS
codeword; retrieval catches this deterministically (any ``k`` proof-valid
shards reconstruct, re-encode, and re-root — a non-codeword mismatches for
EVERY subset) and the contribution resolves to nothing, attributed to the
proposer.  Certs are verified at batch decode against the batch era's key
map; a cert that rode an era rotation (decoded after the local key map
rotated) is accepted as ordered — ordering is already final there and the
retrieval re-verification still binds the payload to the root.

The port's copy of the JAX package's module.  The dispersal's erasure code
goes through ``ops/rs.py``'s host API on the ``Disperser``'s ``device``
(``VidQueueingHoneyBadger`` hands it its DHB's); under
``HBBFT_ERASURE_BACKEND=device`` it runs on the card.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import bls12_381 as _bls
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.ops import rs
from hbbft_tpu_torch.ops.merkle import MerkleTree, Proof
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.protocols.broadcast import _encode_value
from hbbft_tpu_torch.protocols.dynamic_honey_badger import ChangeState, DhbBatch
from hbbft_tpu_torch.protocols.queueing_honey_badger import (
    QueueingHoneyBadger,
    _de_txs,
    _ser_txs,
)
from hbbft_tpu_torch.traits import Step

NodeId = Hashable

#: domain separator for availability-vote transcripts (the same plain
#: per-era BLS keys the authenticated transport signs hellos with)
VOTE_DOMAIN = b"hbbft-vid-avail/"

#: magic prefix marking a DHB contribution as a VID commitment; anything
#: else decodes through the classic ``_de_txs`` path
COMMIT_MAGIC = b"VID1"

#: proposer-side payload retention for local post-commit resolution (own
#: contributions never round-trip the network)
_PAYLOAD_KEEP = 64

#: receiver-side cache of cast votes (re-disperses re-send, never re-sign)
_VOTED_KEEP = 256


def vote_transcript(era: int, root: bytes, total_len: int) -> bytes:
    return VOTE_DOMAIN + wire.u64(era) + root + wire.u64(total_len)


def payload_digest(payload: bytes) -> str:
    """Short hex digest the audit corroborates cert vs retrieval with."""
    return hashlib.sha3_256(payload).hexdigest()[:16]


# ===========================================================================
# Wire messages
# ===========================================================================


@dataclass(frozen=True)
class VidDisperse:
    """Proposer → node ``proof.index``: your shard of ``root``."""

    era: int
    root: bytes
    total_len: int
    proof: Proof


@dataclass(frozen=True)
class VidVote:
    """Node → proposer: signed "I hold my shard of ``root``"."""

    era: int
    root: bytes
    sig: tc.Signature


@dataclass(frozen=True)
class VidCert:
    """``n − f`` availability votes: the retrievability certificate the
    epoch orders (inside a ``VID1`` contribution payload)."""

    era: int
    root: bytes
    total_len: int
    votes: Tuple[Tuple[NodeId, tc.Signature], ...]


@dataclass(frozen=True)
class VidRetrieve:
    """Requester → peer: send me your stored shard of ``root``."""

    root: bytes


@dataclass(frozen=True)
class VidShard:
    """Peer → requester: my shard of ``root`` with its inclusion proof."""

    root: bytes
    total_len: int
    proof: Proof


# ===========================================================================
# Commitment payload codec
# ===========================================================================


def encode_commitment(cert: VidCert) -> bytes:
    return COMMIT_MAGIC + wire.encode_message(cert)


def decode_commitment(payload: bytes) -> Optional[VidCert]:
    """``VID1`` payload → :class:`VidCert`; ``None`` for plain payloads.

    Raises ``ValueError`` on a ``VID1`` prefix over garbage — the caller
    faults the proposer exactly like a ``_de_txs`` failure.
    """
    if not payload.startswith(COMMIT_MAGIC):
        return None
    msg = wire.decode_message(payload[len(COMMIT_MAGIC):])
    if not isinstance(msg, VidCert):
        raise ValueError("VID1 payload does not contain a VidCert")
    return msg


def verify_cert(cert: VidCert, netinfo) -> bool:
    """``n − f`` distinct validator votes, each a valid signature over the
    cert's transcript, checked against ``netinfo``'s key map.

    Every vote signs the SAME transcript, so the whole cert verifies with
    one aggregated pairing check (sum the G1 keys, sum the G2 signatures)
    instead of one pairing per vote — the per-epoch cost that dominated
    VID commit latency.  Rogue-key aggregation is not a concern here: the
    per-node keys come from the trusted keygen/DKG key map, never from
    the cert itself.  If the aggregate fails (some signature is garbage)
    fall back to counting individually valid votes, so a cert carrying
    ``n − f`` good votes plus junk still verifies exactly as before."""
    need = netinfo.num_nodes() - netinfo.num_faulty()
    transcript = vote_transcript(cert.era, cert.root, cert.total_len)
    pairs = []
    seen = set()
    for nid, sig in cert.votes:
        if nid in seen:
            continue
        seen.add(nid)
        pk = netinfo.public_key(nid)
        if pk is not None:
            pairs.append((pk, sig))
    if len(pairs) < need:
        return False
    agg_pk = pairs[0][0].point
    agg_sig = pairs[0][1].point
    for pk, sig in pairs[1:]:
        agg_pk = _bls.g1_add(agg_pk, pk.point)
        agg_sig = _bls.g2_add(agg_sig, sig.point)
    if _bls.pairing_check([
        (_bls.g1_neg(_bls.G1_GEN), agg_sig),
        (agg_pk, _bls.hash_g2(transcript)),
    ]):
        return True
    valid = sum(1 for pk, sig in pairs if pk.verify(sig, transcript))
    return valid >= need


# ===========================================================================
# Committed-batch type (ordering output, pre-retrieval)
# ===========================================================================


@dataclass(frozen=True)
class VidQhbBatch:
    """An ordered epoch in VID mode: raw contribution payloads, each
    either a ``VID1`` commitment (transactions pending retrieval) or a
    plain ``_ser_txs`` payload (resolved inline).  Deliberately has NO
    ``all_txs`` — the driver owns resolution and journals ``commit`` /
    ``commit_retrieved`` itself."""

    era: int
    epoch: int
    contributions: Tuple[Tuple[NodeId, bytes], ...]
    change: ChangeState

    def commitments(self) -> List[Tuple[NodeId, VidCert]]:
        """The (proposer, cert) pairs still needing retrieval."""
        out = []
        for proposer, payload in self.contributions:
            if payload.startswith(COMMIT_MAGIC):
                cert = decode_commitment(payload)
                if cert is not None:
                    out.append((proposer, cert))
        return out

    def plain_txs(self) -> List[Tuple[NodeId, Tuple[bytes, ...]]]:
        """The non-VID contributions, decoded (pre-validated in
        ``_process`` — a payload that fails here was never included)."""
        out = []
        for proposer, payload in self.contributions:
            if not payload.startswith(COMMIT_MAGIC):
                out.append((proposer, _de_txs(payload)))
        return out


@dataclass(frozen=True)
class VidCertReady:
    """Step output marking a completed dispersal: the driver journals the
    ``vid_cert`` audit note from it (root / length / payload digest), the
    corroboration anchor for every later ``vid_retrieved`` note."""

    era: int
    root: bytes
    total_len: int
    payload_sha3: str


# ===========================================================================
# Dispersal engine
# ===========================================================================


@dataclass
class _Pending:
    era: int
    total_len: int
    need: int
    votes: Dict[NodeId, tc.Signature] = field(default_factory=dict)


class Disperser:
    """Per-node sans-I/O dispersal state: proposer-side encode + vote
    collection, receiver-side proof-checked shard storage + voting.

    ``store`` is the bounded shard store shared with the retrieval
    service (:class:`hbbft_tpu_torch.net.retrieve.ShardStore` or anything with
    its ``put``/``proof_for`` surface).  ``device`` is where the dispersal's
    erasure code runs under the ``device`` backend (default ``"cuda"``,
    raising without a card)."""

    def __init__(self, store, device="cuda"):
        self.store = store
        self.device = resolve_device(device)
        self._pending: Dict[bytes, _Pending] = {}
        self._payloads: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._voted: "OrderedDict[Tuple[int, bytes, int], object]" = \
            OrderedDict()
        # deterministic plain-int counters (metrics snapshot these)
        self.disperses = 0
        self.votes_cast = 0
        self.certs = 0

    # -- proposer side -------------------------------------------------------

    def disperse(self, era: int, netinfo, payload: bytes
                 ) -> Tuple[bytes, Step]:
        """Encode ``payload``, ship each node its shard + proof, store our
        own, and open vote collection (our own vote pre-counted)."""
        n = netinfo.num_nodes()
        coder = rs.for_n_f(n, netinfo.num_faulty())
        shards, leaves = _encode_value(coder, payload, self.device)
        tree = MerkleTree.from_shards(shards, leaves)
        root = tree.root_hash()
        total_len = len(payload)
        our = netinfo.our_id()
        step = Step()
        for nid in netinfo.all_ids():
            proof = tree.proof(netinfo.node_index(nid))
            if nid == our:
                self.store.put(root, total_len, proof)
            else:
                step.send_to(nid, VidDisperse(era, root, total_len, proof))
        self._payloads[root] = payload
        while len(self._payloads) > _PAYLOAD_KEEP:
            self._payloads.popitem(last=False)
        sig = netinfo.secret_key().sign(
            vote_transcript(era, root, total_len))
        self._pending[root] = _Pending(
            era=era, total_len=total_len,
            need=n - netinfo.num_faulty(), votes={our: sig})
        self.disperses += 1
        return root, step

    def cert_if_ready(self, root: bytes) -> Optional[VidCert]:
        """The completed cert for ``root`` (consumes the pending entry) —
        immediately ready on single-node networks where our own vote is
        already ``n − f``."""
        pend = self._pending.get(root)
        if pend is None or len(pend.votes) < pend.need:
            return None
        del self._pending[root]
        self.certs += 1
        return VidCert(
            era=pend.era, root=root, total_len=pend.total_len,
            votes=tuple(sorted(pend.votes.items(),
                               key=lambda kv: repr(kv[0]))))

    def local_payload(self, root: bytes) -> Optional[bytes]:
        """Our own dispersed payload, for commit-time local resolution."""
        return self._payloads.get(root)

    def handle_vote(self, netinfo, sender: NodeId, msg: VidVote
                    ) -> Tuple[Step, Optional[VidCert]]:
        pend = self._pending.get(msg.root)
        if pend is None or msg.era != pend.era:
            # late vote for a completed/abandoned dispersal — benign
            return Step(), None
        if sender in pend.votes:
            return Step(), None
        pk = netinfo.public_key(sender)
        if pk is None or not pk.verify(
                msg.sig, vote_transcript(pend.era, msg.root,
                                         pend.total_len)):
            return Step.from_fault(sender, FaultKind.VidInvalidVote), None
        pend.votes[sender] = msg.sig
        return Step(), self.cert_if_ready(msg.root)

    # -- receiver side -------------------------------------------------------

    def handle_disperse(self, netinfo, sender: NodeId, msg: VidDisperse
                        ) -> Step:
        our_index = netinfo.node_index(netinfo.our_id())
        p = msg.proof
        if (p.index != our_index or p.root_hash != msg.root
                or not p.validate(netinfo.num_nodes())):
            return Step.from_fault(sender, FaultKind.VidInvalidDisperse)
        self.store.put(msg.root, msg.total_len, p)
        # A proposer whose contribution was excluded from an epoch's
        # subset re-samples the same queue and re-disperses the same
        # root; staying silent here would starve it of votes forever.
        # Re-send the cached vote instead — never re-sign.
        key = (msg.era, msg.root, msg.total_len)
        sig = self._voted.get(key)
        if sig is None:
            sig = netinfo.secret_key().sign(
                vote_transcript(msg.era, msg.root, msg.total_len))
            self._voted[key] = sig
            while len(self._voted) > _VOTED_KEEP:
                self._voted.popitem(last=False)
            self.votes_cast += 1
        return Step().send_to(
            sender, VidVote(msg.era, msg.root, sig))


# ===========================================================================
# VID-mode QueueingHoneyBadger
# ===========================================================================


class VidQueueingHoneyBadger(QueueingHoneyBadger):
    """QHB where proposals are dispersed first and epochs order only the
    ``(root, cert)`` commitment.

    One dispersal is in flight at a time (``propose_ahead`` pipelining is
    classic-mode only and no-ops here); a dispersal orphaned by epoch/era
    progress is abandoned and re-sampled, so vote loss can delay but
    never wedge proposals.  Committed epochs come out as
    :class:`VidQhbBatch`; the driver resolves payloads (locally for our
    own roots, via :mod:`hbbft_tpu_torch.net.retrieve` for the rest) and calls
    :meth:`on_retrieved` so committed transactions leave the queue.

    The dispersal runs on the wrapped DHB's ``device``."""

    def __init__(self, dhb, batch_size: int = 100, rng=None, queue=None,
                 shard_store=None):
        super().__init__(dhb, batch_size=batch_size, rng=rng, queue=queue)
        if shard_store is None:
            from hbbft_tpu_torch.net.retrieve import ShardStore

            shard_store = ShardStore()
        self.store = shard_store
        self.disperser = Disperser(shard_store, device=dhb.device)
        self._disperse_root: Optional[bytes] = None
        self._disperse_key: Tuple[int, int] = (0, 0)

    # -- ConsensusProtocol ---------------------------------------------------

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if isinstance(message, VidDisperse):
            return self.disperser.handle_disperse(
                self.dhb.netinfo, sender_id, message)
        if isinstance(message, VidVote):
            step, cert = self.disperser.handle_vote(
                self.dhb.netinfo, sender_id, message)
            if cert is not None and cert.root == self._disperse_root:
                step.extend(self._propose_cert(cert))
            return step
        return super().handle_message(sender_id, message)

    def propose_ahead(self, depth: int) -> Step:
        # VID pipelining would need per-epoch concurrent dispersals;
        # depth collapses to the sequential disperse→cert→propose flow
        return Step()

    # -- internals -----------------------------------------------------------

    def _maybe_propose(self, force: bool = False) -> Step:
        if not self.dhb.is_validator():
            return Step()
        hb = self.dhb.hb
        if hb.has_input.get(hb.epoch):
            return Step()
        if self._disperse_root is not None:
            if (self.dhb.era, hb.epoch) <= self._disperse_key:
                return Step()  # cert collection for this epoch in flight
            # epoch moved on without our cert (lost votes / era rotation):
            # abandon and re-sample below
            self.disperser._pending.pop(self._disperse_root, None)
            self._disperse_root = None
        sample = self.queue.choose(self.rng, self.batch_size)
        if not sample:
            if not force:
                return Step()
            # liveness keep-alive stays a plain empty contribution —
            # nothing to disperse
            return self._process(self.dhb.propose(_ser_txs([])))
        self._proposed[(self.dhb.era, hb.epoch)] = tuple(sample)
        era = self.dhb.era
        root, step = self.disperser.disperse(
            era, self.dhb.netinfo, _ser_txs(sample))
        self._disperse_root = root
        self._disperse_key = (era, hb.epoch)
        cert = self.disperser.cert_if_ready(root)  # n − f == 1 networks
        if cert is not None:
            step.extend(self._propose_cert(cert))
        return step

    def _propose_cert(self, cert: VidCert) -> Step:
        self._disperse_root = None
        if cert.era != self.dhb.era:
            # the cert straddled an era rotation: its votes verify only
            # under the old key map — drop it and re-propose fresh
            return self._maybe_propose()
        step = Step()
        payload = self.disperser.local_payload(cert.root)
        if payload is not None:
            step.output.append(VidCertReady(
                era=cert.era, root=cert.root, total_len=cert.total_len,
                payload_sha3=payload_digest(payload)))
        return step.extend(self._process(self.dhb.propose(
            encode_commitment(cert))))

    def on_retrieved(self, txs) -> None:
        """Driver callback once a foreign commitment's payload resolved:
        committed transactions leave the queue so they are not
        re-proposed."""
        self.queue.remove_multiple({bytes(t) for t in txs})

    def _process(self, inner: Step) -> Step:
        if not inner.output:
            return inner
        step = Step(fault_log=inner.fault_log, messages=inner.messages)
        for out in inner.output:
            if isinstance(out, VidCertReady):
                step.output.append(out)
                continue
            if not isinstance(out, DhbBatch):
                continue
            contribs: List[Tuple[NodeId, bytes]] = []
            committed: List[bytes] = []
            for proposer, payload in out.contributions:
                if payload.startswith(COMMIT_MAGIC):
                    try:
                        cert = decode_commitment(payload)
                    # hblint: disable=fault-swallowed-drop (accounted
                    # below: a None cert is the proposer's counted
                    # VidInvalidCert fault, never a silent skip)
                    except ValueError:
                        cert = None
                    # our own slot needs no cert verification: the subset
                    # binds it to OUR broadcast, and we assembled the cert
                    # from individually verified votes in handle_vote
                    ok = (cert is not None and cert.era == out.era
                          and (proposer == self.our_id()
                               or out.era != self.dhb.era
                               or verify_cert(cert, self.dhb.netinfo)))
                    if not ok:
                        step.fault(proposer, FaultKind.VidInvalidCert)
                        continue
                    contribs.append((proposer, payload))
                    if proposer == self.our_id():
                        local = self.disperser.local_payload(cert.root)
                        if local is not None:
                            committed.extend(_de_txs(local))
                else:
                    try:
                        txs = _de_txs(payload)
                    except ValueError:
                        step.fault(
                            proposer, FaultKind.BatchDeserializationFailed)
                        continue
                    contribs.append((proposer, payload))
                    committed.extend(txs)
            self.queue.remove_multiple(set(committed))
            for k in [k for k in self._proposed
                      if k <= (out.era, out.epoch)]:
                del self._proposed[k]
            step.output.append(VidQhbBatch(
                era=out.era, epoch=out.epoch,
                contributions=tuple(contribs), change=out.change))
        if step.output:
            step.extend(self._maybe_propose())
        return step

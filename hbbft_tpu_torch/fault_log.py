"""Byzantine-fault evidence accumulation.

The port's copy of the JAX package's ``fault_log.py`` (reference:
``src/fault_log.rs`` — ``Fault``, ``FaultLog``, ``FaultKind``): protocols
never panic on misbehaving peers — they record the evidence in the ``Step``
they return and carry on.  The caller decides what to do with the log.

One flat enum holds every variant name a protocol needs (the reference
splits them into per-module enums in newer versions).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Hashable, Iterable, List


class FaultKind(enum.Enum):
    """Why a node was logged as faulty.

    Variant set follows the reference's per-protocol fault enums
    (``src/fault_log.rs :: FaultKind`` and the per-module enums that replaced
    it upstream).
    """

    # broadcast
    InvalidProof = "broadcast: Value/Echo carried an invalid Merkle proof"
    MultipleValues = "broadcast: received multiple Values from the proposer"
    MultipleEchos = "broadcast: received multiple Echos from a node"
    MultipleReadys = "broadcast: received multiple Readys from a node"
    MultipleEchoHashes = "broadcast: received multiple EchoHashes from a node"
    MultipleCanDecodes = "broadcast: received multiple CanDecodes from a node"
    NotAProposer = "broadcast: Value message from a node that is not the proposer"
    UnknownSender = "message from a node that is not on the network"
    # binary agreement
    # (the reference's DuplicateBVal/DuplicateAux are intentionally absent:
    # Term substitutes for its sender's BVal/Aux here, so same-value repeats
    # are indistinguishable from honest reordering and are treated as benign)
    MultipleConf = "binary_agreement: multiple Conf from a node"
    MultipleTerm = "binary_agreement: multiple Term from a node"
    AgreementEpochMismatch = "binary_agreement: message for an impossible epoch"
    # threshold sign / decrypt
    UnexpectedSignatureShare = "threshold_sign: share before the document was set"
    InvalidSignatureShare = "threshold_sign: invalid signature share"
    MultipleSignatureShares = "threshold_sign: multiple shares from a node"
    UnexpectedDecryptionShare = "threshold_decrypt: share before ciphertext set"
    InvalidDecryptionShare = "threshold_decrypt: invalid decryption share"
    MultipleDecryptionShares = "threshold_decrypt: multiple shares from a node"
    # honey badger
    InvalidCiphertext = "honey_badger: proposed an invalid ciphertext"
    BatchDeserializationFailed = "honey_badger: contribution failed to deserialize"
    UnexpectedHbMessage = "honey_badger: message for an epoch outside the window"
    DecryptionFailed = "honey_badger: threshold decryption failed"
    FutureEpochFlood = (
        "honey_badger: per-sender future-epoch message budget exhausted "
        "(window-edge spam; the message was dropped, counted)"
    )
    # subset
    InvalidSubsetMessage = "subset: message for an unknown proposer"
    SubsetMessageFlood = (
        "subset: per-sender message budget for one ACS instance "
        "exhausted (flood; the message was dropped, counted)"
    )
    # dynamic honey badger / key gen
    InvalidVoteSignature = "dynamic_honey_badger: invalid vote signature"
    InvalidKeyGenMessage = "dynamic_honey_badger: invalid Part/Ack"
    UnexpectedKeyGenPart = "dynamic_honey_badger: Part from a non-candidate"
    InvalidPart = "sync_key_gen: invalid Part (bad commitment/row)"
    InvalidAck = "sync_key_gen: invalid Ack (bad value)"
    EchoHashConflict = "broadcast: EchoHash conflicts with a full Echo"
    # (EchoHashConflict is raised by broadcast when a node's hash-only echo
    # evidence names a different root than its full Echo)
    # verifiable information dispersal
    VidInvalidDisperse = (
        "vid: Disperse carried an invalid or misdirected Merkle proof"
    )
    VidInvalidVote = "vid: availability vote with an invalid signature"
    VidInvalidCert = (
        "vid: committed contribution carried an invalid retrievability "
        "certificate"
    )
    VidShardProofInvalid = (
        "vid: retrieved shard failed its Merkle proof (counted; "
        "reconstruction proceeds from other donors)"
    )
    VidReconstructMismatch = (
        "vid: reconstructed shards do not re-root to the committed "
        "commitment (non-codeword dispersal — proposer fault)"
    )


def equivocation_kinds() -> frozenset:
    """The :class:`FaultKind` variants that denote *equivocation* — one
    sender emitting conflicting values for the same protocol slot — as
    opposed to merely invalid or mistimed input.  This is the evidence
    class a forensic auditor can reconstruct from merged per-node
    journals: two receivers holding
    different values from the same sender for one slot is proof of
    misbehavior regardless of which value is "right"."""
    return frozenset({
        FaultKind.MultipleValues,
        FaultKind.MultipleEchos,
        FaultKind.MultipleEchoHashes,
        FaultKind.MultipleCanDecodes,
        FaultKind.MultipleReadys,
        FaultKind.MultipleConf,
        FaultKind.MultipleTerm,
        FaultKind.MultipleSignatureShares,
        FaultKind.MultipleDecryptionShares,
    })


@dataclass(frozen=True)
class Fault:
    """One piece of evidence: ``node_id`` did ``kind``.

    Reference: ``src/fault_log.rs :: Fault``.
    """

    node_id: Hashable
    kind: FaultKind

    def __repr__(self) -> str:  # keep logs short
        return f"Fault({self.node_id!r}, {self.kind.name})"


@dataclass
class FaultLog:
    """An append-only list of :class:`Fault` entries.

    Reference: ``src/fault_log.rs :: FaultLog``.
    """

    faults: List[Fault] = field(default_factory=list)

    @classmethod
    def init(cls, node_id: Hashable, kind: FaultKind) -> "FaultLog":
        return cls([Fault(node_id, kind)])

    def append(self, node_id: Hashable, kind: FaultKind) -> None:
        self.faults.append(Fault(node_id, kind))

    def extend(self, other: "FaultLog") -> None:
        self.faults.extend(other.faults)

    def is_empty(self) -> bool:
        return not self.faults

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def __bool__(self) -> bool:
        return bool(self.faults)

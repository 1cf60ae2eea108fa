"""Threshold signing — the common-coin primitive.

Reference: ``src/threshold_sign.rs :: ThresholdSign<N>`` — every validator
BLS-signs a session-unique document; t+1 = f+1 valid shares interpolate to a
unique group signature (independent of *which* shares), whose hash is the
unpredictable common coin for binary agreement.

Optimisation over the reference: *optimistic combination*.  The reference
pairing-verifies every incoming share (the protocol's hottest loop, O(N²)
pairings per coin network-wide).  We combine any t+1 unverified shares and
verify the combined signature once; only if that fails do we fall back to
per-share verification to identify and fault the culprits.  With honest
shares this is 1 pairing-check per node instead of f+1.  The batched
verifier of ``crypto/batch.py`` uses the same trick in array form.

The port's copy of the JAX package's module (host work only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, Optional

from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

NodeId = Hashable


@dataclass(frozen=True)
class ThresholdSignMessage:
    share: tc.SignatureShare


class ThresholdSign(ConsensusProtocol):
    """Reference: ``src/threshold_sign.rs``."""

    def __init__(self, netinfo: NetworkInfo, optimistic: bool = True):
        self.netinfo = netinfo
        self.document: Optional[bytes] = None
        self.shares: Dict[NodeId, tc.SignatureShare] = {}
        self.verified: Dict[NodeId, bool] = {}
        self.pending: Dict[NodeId, tc.SignatureShare] = {}
        self.signature: Optional[tc.Signature] = None
        self.had_input = False
        self.optimistic = optimistic

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return self.signature is not None

    # -- API ----------------------------------------------------------------

    def set_document(self, document: bytes) -> Step:
        """Define what is being signed; processes any queued shares."""
        if self.document is not None:
            return Step()
        self.document = bytes(document)
        step = Step()
        pending, self.pending = self.pending, {}
        for sender, share in pending.items():
            step.extend(self._handle_share(sender, share))
        return step

    def sign(self) -> Step:
        """Sign the document and broadcast our share (reference ``sign``)."""
        if self.had_input:
            return Step()
        if self.document is None:
            raise ValueError("set_document before sign")
        self.had_input = True
        if not self.netinfo.is_validator():
            return Step()
        share = self.netinfo.secret_key_share().sign(self.document)
        step = Step()
        step.send_all(ThresholdSignMessage(share))
        step.extend(self._handle_share(self.our_id(), share))
        return step

    def handle_input(self, input: bytes) -> Step:
        """Input = the document; sets and signs in one go."""
        step = self.set_document(input)
        return step.extend(self.sign())

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            return Step.from_fault(sender_id, FaultKind.UnknownSender)
        if not isinstance(message, ThresholdSignMessage):
            raise TypeError(f"unknown threshold_sign message {message!r}")
        if self.document is None:
            # buffer until the document is known (can arrive first under
            # adversarial schedules)
            if sender_id in self.pending:
                if self.pending[sender_id] == message.share:
                    return Step()  # network replay — idempotent
                return Step.from_fault(
                    sender_id, FaultKind.MultipleSignatureShares
                )
            self.pending[sender_id] = message.share
            return Step()
        return self._handle_share(sender_id, message.share)

    # -- internals ----------------------------------------------------------

    def _handle_share(self, sender_id: NodeId, share: tc.SignatureShare) -> Step:
        if self.signature is not None:
            return Step()
        if sender_id in self.shares:
            if self.shares[sender_id] == share:
                return Step()  # network replay — idempotent
            return Step.from_fault(sender_id, FaultKind.MultipleSignatureShares)
        pks = self.netinfo.public_key_set()
        if not self.optimistic:
            idx = self.netinfo.node_index(sender_id)
            if not pks.verify_signature_share(idx, share, self.document):
                return Step.from_fault(
                    sender_id, FaultKind.InvalidSignatureShare
                )
            self.verified[sender_id] = True
        self.shares[sender_id] = share
        return self._try_output()

    def _try_output(self) -> Step:
        pks = self.netinfo.public_key_set()
        t = pks.threshold()
        if len(self.shares) < t + 1:
            return Step()
        indexed = {
            self.netinfo.node_index(nid): s for nid, s in self.shares.items()
        }
        sig = pks.combine_signatures(indexed)
        if pks.verify_signature(sig, self.document):
            self.signature = sig
            return Step.from_output(sig)
        # Pessimistic fallback: someone sent garbage — verify individually,
        # evict + fault the liars, wait for more shares.
        step = Step()
        for nid in list(self.shares.keys()):
            if self.verified.get(nid):
                continue
            idx = self.netinfo.node_index(nid)
            if pks.verify_signature_share(idx, self.shares[nid], self.document):
                self.verified[nid] = True
            else:
                del self.shares[nid]
                step.fault(nid, FaultKind.InvalidSignatureShare)
        return step.extend(self._try_output() if len(self.shares) >= t + 1 else Step())

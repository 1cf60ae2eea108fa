"""Threshold decryption of one TPKE ciphertext.

Reference: ``src/threshold_decrypt.rs :: ThresholdDecrypt<N>`` — collect
t+1 = f+1 valid decryption shares for a ciphertext and interpolate the
plaintext mask.

Optimisation over the reference (which pairing-verifies every share): a
Fiat–Shamir batch verification — check
``e(Σ ρ_i·share_i, H) == e(Σ ρ_i·pk_i, W)`` with coefficients ρ_i derived by
hashing the share set — one pairing-check for the whole set; per-share
verification only runs as a fallback to attribute blame.

The port's copy of the JAX package's module.  The set's two folds go
through ``crypto/batch.py``'s ``rlc_fold_g1`` on the instance's ``device``:
the windowed ladder kernel from ``DEVICE_FOLD_MIN_BATCH`` rows (t + 1 ≥ 8,
N ≥ 22), the host below.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Hashable, Optional

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import bls12_381 as bls
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

NodeId = Hashable


@dataclass(frozen=True)
class DecryptionMessage:
    share: tc.DecryptionShare


class ThresholdDecrypt(ConsensusProtocol):
    """Reference: ``src/threshold_decrypt.rs``."""

    def __init__(self, netinfo: NetworkInfo, device="cuda"):
        self.netinfo = netinfo
        # where the share-set folds run when their batch threshold routes
        # them to the device
        self.device = resolve_device(device)
        self.ciphertext: Optional[tc.Ciphertext] = None
        self.shares: Dict[NodeId, tc.DecryptionShare] = {}
        self.verified: Dict[NodeId, bool] = {}
        self.pending: Dict[NodeId, tc.DecryptionShare] = {}
        self.plaintext: Optional[bytes] = None
        self.had_input = False
        # Deferred-verification hook (the epoch-pipelined runtime's seam):
        # when set, reaching t+1 shares does NOT verify inline — the chosen
        # share set is parked and ``defer_verify(self)`` registers this
        # instance with the caller, who verifies MANY instances (across the
        # epochs in flight) in one merged pairing-product call and resumes
        # each via :meth:`finish_deferred`.  None (the default) keeps the
        # reference-exact inline behavior — the simulator path.
        self.defer_verify = None
        self._deferred_items = None

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return self.plaintext is not None

    # -- API ----------------------------------------------------------------

    def set_ciphertext(self, ct: tc.Ciphertext,
                       share: Optional[tc.DecryptionShare] = None) -> Step:
        """Set the ciphertext, emit our share, process buffered shares.

        The caller must have validated ``ct`` (``Ciphertext.verify``) —
        HoneyBadger does this when accepting a subset contribution.
        ``share`` may carry our own pre-computed decryption share (the
        batched generation path, ``crypto.batch.batch_decrypt_share_gen``);
        it must equal what ``decrypt_share(ct, check=False)`` returns.
        """
        if self.ciphertext is not None:
            return Step()
        self.ciphertext = ct
        step = Step()
        if self.netinfo.is_validator():
            self.had_input = True
            if share is None:
                # check=False: HoneyBadger validates the ciphertext on
                # acceptance
                share = self.netinfo.secret_key_share().decrypt_share(
                    ct, check=False
                )
            step.send_all(DecryptionMessage(share))
            step.extend(self._handle_share(self.our_id(), share))
        pending, self.pending = self.pending, {}
        for sender, share in pending.items():
            step.extend(self._handle_share(sender, share))
        return step

    def handle_input(self, input: tc.Ciphertext) -> Step:
        return self.set_ciphertext(input)

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            return Step.from_fault(sender_id, FaultKind.UnknownSender)
        if not isinstance(message, DecryptionMessage):
            raise TypeError(f"unknown threshold_decrypt message {message!r}")
        if self.ciphertext is None:
            if sender_id in self.pending:
                if self.pending[sender_id] == message.share:
                    return Step()  # network replay — idempotent
                return Step.from_fault(
                    sender_id, FaultKind.MultipleDecryptionShares
                )
            self.pending[sender_id] = message.share
            return Step()
        return self._handle_share(sender_id, message.share)

    # -- internals ----------------------------------------------------------

    def _handle_share(self, sender_id: NodeId, share: tc.DecryptionShare) -> Step:
        if self.plaintext is not None:
            return Step()
        if sender_id in self.shares:
            if self.shares[sender_id] == share:
                return Step()  # network replay — idempotent
            return Step.from_fault(sender_id, FaultKind.MultipleDecryptionShares)
        self.shares[sender_id] = share
        return self._try_output()

    def _batch_verify(self, items) -> bool:
        """One pairing-check for many shares via a hash-derived random
        linear combination (soundness error ~2^-255).  The two MSM folds
        route through :func:`hbbft_tpu_torch.crypto.batch.rlc_fold_g1` on
        ``self.device`` — host muls below ``DEVICE_FOLD_MIN_BATCH`` rows,
        the windowed ladder from there."""
        from hbbft_tpu_torch.crypto.batch import rlc_fold_g1

        ct = self.ciphertext
        h = tc._hash_ciphertext_point(ct.u, ct.v)
        seed = hashlib.sha3_256(
            b"HBBFT-TD-BATCH"
            + ct.to_bytes()
            + b"".join(s.to_bytes() for _, s in items)
        ).digest()
        rhos = [
            int.from_bytes(
                hashlib.sha3_256(seed + k.to_bytes(4, "big")).digest(),
                "big",
            )
            % bls.R
            for k in range(len(items))
        ]
        pks = self.netinfo.public_key_set()
        acc_share = rlc_fold_g1([s.point for _, s in items], rhos,
                                device=self.device)
        acc_pk = rlc_fold_g1(
            [pks.public_key_share(idx).point for idx, _ in items], rhos,
            device=self.device,
        )
        return bls.pairing_check(
            [(bls.g1_neg(acc_share), h), (acc_pk, ct.w)]
        )

    def deferred_job(self):
        """``(items, ciphertext)`` of the parked verification, or None."""
        if self._deferred_items is None:
            return None
        return self._deferred_items, self.ciphertext

    def finish_deferred(self, ok: bool) -> Step:
        """Resume a deferred verification with the batch verdict.

        ``ok=True`` decrypts from the parked share set (exactly what the
        inline path would have done); ``ok=False`` re-runs the full inline
        path — per-share blame fallback included — so fault attribution is
        identical to the undeferred protocol."""
        items, self._deferred_items = self._deferred_items, None
        if (items is None or self.plaintext is not None
                or self.ciphertext is None):
            return Step()
        if ok:
            pks = self.netinfo.public_key_set()
            self.plaintext = pks.decrypt(dict(items), self.ciphertext)
            return Step.from_output(self.plaintext)
        defer, self.defer_verify = self.defer_verify, None
        try:
            return self._try_output()
        finally:
            self.defer_verify = defer

    def _try_output(self) -> Step:
        pks = self.netinfo.public_key_set()
        t = pks.threshold()
        if len(self.shares) < t + 1:
            return Step()
        chosen = sorted(self.shares.items(), key=lambda kv: repr(kv[0]))[: t + 1]
        items = [(self.netinfo.node_index(nid), s) for nid, s in chosen]
        if self.defer_verify is not None:
            if self._deferred_items is None:
                self._deferred_items = items
                self.defer_verify(self)
            return Step()
        if self._batch_verify(items):
            plaintext = pks.decrypt(dict(items), self.ciphertext)
            self.plaintext = plaintext
            return Step.from_output(plaintext)
        # someone lied: verify individually, evict, wait for more
        step = Step()
        for nid in [nid for nid, _ in chosen]:
            if self.verified.get(nid):
                continue
            idx = self.netinfo.node_index(nid)
            ok = pks.public_key_share(idx).verify_decryption_share(
                self.shares[nid], self.ciphertext
            )
            if ok:
                self.verified[nid] = True
            else:
                del self.shares[nid]
                step.fault(nid, FaultKind.InvalidDecryptionShare)
        if len(self.shares) >= t + 1:
            step.extend(self._try_output())
        return step

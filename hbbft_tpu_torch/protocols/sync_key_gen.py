"""Synchronous distributed key generation (DKG).

Reference: ``src/sync_key_gen.rs :: SyncKeyGen<N>`` — a Pedersen-style DKG
over symmetric bivariate polynomials (``threshold_crypto::BivarPoly``):

- Every dealer d samples a symmetric bivariate poly f_d of degree t and
  broadcasts a ``Part``: the G1 commitment matrix plus, for each node j, the
  row f_d(j+1, ·) encrypted to j's plain public key.
- Node i validates its row against the commitment and answers with an
  ``Ack`` carrying f_d(i+1, j+1) encrypted to each node j — giving every j
  evidence that i's row is consistent (symmetry: f_d(i+1, j+1) is also a
  point on j's row).
- A Part is *complete* with 2t+1 valid Acks; the DKG ``is_ready`` with t+1
  complete Parts (≥ 1 honest dealer).  ``generate()`` sums the complete
  dealers: node i's secret share is Σ_d f_d(i+1, 0) (decrypted row at 0) and
  the public commitment is Σ_d commit_d.row(0).

SyncKeyGen needs *external agreement* on which Parts/Acks count, in what
order — ``DynamicHoneyBadger`` provides it by committing the messages
through consensus; tests provide it by identical delivery order.

The port's copy of the JAX package's module.  Its commitment checks and the
dealer's commitment go through the port's ``crypto/batch.py`` on ``device``
(the device ladder above each call's batch threshold, else the host).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.fault_log import FaultKind

NodeId = Hashable


def _ser_poly(poly: tc.Poly) -> bytes:
    out = struct.pack(">I", len(poly.coeffs))
    for coef in poly.coeffs:
        out += coef.to_bytes(32, "big")
    return out


def _de_poly(data: bytes) -> Optional[tc.Poly]:
    if len(data) < 4:
        return None
    (n,) = struct.unpack(">I", data[:4])
    if len(data) < 4 + 32 * n or n == 0 or n > 1024:
        return None
    return tc.Poly(
        [int.from_bytes(data[4 + 32 * i : 36 + 32 * i], "big") for i in range(n)]
    )


@dataclass(frozen=True)
class Part:
    """Dealer's proposal.  Reference: ``sync_key_gen.rs :: Part``."""

    commitment: tc.BivarCommitment
    rows: Tuple[tc.Ciphertext, ...]  # rows[j] encrypted to node j


@dataclass(frozen=True)
class Ack:
    """Row acknowledgement.  Reference: ``sync_key_gen.rs :: Ack``."""

    proposer_index: int
    values: Tuple[tc.Ciphertext, ...]  # values[j] encrypted to node j


class PartOutcome:
    def __init__(self, ack: Optional[Ack] = None, fault: Optional[FaultKind] = None):
        self.ack = ack
        self.fault = fault


class AckOutcome:
    def __init__(self, fault: Optional[FaultKind] = None):
        self.fault = fault


class _ProposalState:
    def __init__(self, commitment: tc.Commitment):
        self.commitment = commitment  # row(our_index+1) commitment? no: full
        self.acks: Set[int] = set()
        self.secret_row_at_zero: Optional[int] = None


class SyncKeyGen:
    """Reference: ``src/sync_key_gen.rs :: SyncKeyGen<N>``."""

    def __init__(
        self,
        our_id: NodeId,
        secret_key: tc.SecretKey,
        pub_keys: Dict[NodeId, tc.PublicKey],
        threshold: int,
        rng,
        device="cuda",
    ):
        self.our_id = our_id
        self.secret_key = secret_key
        self.pub_keys = dict(pub_keys)
        self.ids: List[NodeId] = sorted(pub_keys.keys())
        self.our_index: Optional[int] = (
            self.ids.index(our_id) if our_id in self.ids else None
        )
        self.threshold = threshold
        self.rng = rng
        # where the commitment ladders run when a batch threshold routes
        # them to the device; a plain field (the DHB driver sets it)
        self.device = resolve_device(device)
        self.parts: Dict[int, tc.BivarCommitment] = {}
        self.acks: Dict[int, Set[int]] = {}
        self.our_rows: Dict[int, int] = {}  # dealer idx → f_d(our+1, 0)
        # value cross-checks received via acks: dealer → {acker}
        self._row_polys: Dict[int, tc.Poly] = {}

    # -- dealing -------------------------------------------------------------

    def generate_part(self) -> Part:
        """Sample our bivariate poly and deal rows (done once, by dealers)."""
        from hbbft_tpu_torch.crypto import batch as _batch

        n = len(self.ids)
        bp = tc.BivarPoly.random(self.threshold, self.rng)
        commitment = _batch.bivar_commitment(bp, device=self.device)
        rows = []
        # all n rows in one finite-difference sweep (consecutive share
        # points — the efficient-Shamir evaluation from PAPERS.md)
        for j, row in enumerate(_batch.bivar_rows_range(bp, n)):
            ct = self.pub_keys[self.ids[j]].encrypt(_ser_poly(row), self.rng)
            rows.append(ct)
        return Part(commitment, tuple(rows))

    # -- handling ------------------------------------------------------------

    def handle_part(self, sender_id: NodeId, part: Part) -> PartOutcome:
        """Validate the dealer's Part; if we are a node, decrypt + check our
        row and produce an Ack.  Reference: ``handle_part → PartOutcome``."""
        if sender_id not in self.ids:
            return PartOutcome(fault=FaultKind.UnknownSender)
        dealer = self.ids.index(sender_id)
        if dealer in self.parts:
            return PartOutcome()  # duplicate Part: first one wins
        if (
            part.commitment.degree() != self.threshold
            or len(part.rows) != len(self.ids)
        ):
            return PartOutcome(fault=FaultKind.InvalidPart)
        self.parts[dealer] = part.commitment
        self.acks.setdefault(dealer, set())
        if self.our_index is None:
            return PartOutcome()
        row_bytes = self.secret_key.decrypt(part.rows[self.our_index])
        row = _de_poly(row_bytes) if row_bytes is not None else None
        if row is None or row.degree() > self.threshold:
            return PartOutcome(fault=FaultKind.InvalidPart)
        # check the row against the dealer's commitment (device-batched at
        # large (t+1)² — SURVEY §7 hard part #3)
        from hbbft_tpu_torch.crypto import batch as _batch

        if _batch.commitment_row(
            part.commitment, self.our_index + 1, device=self.device
        ) != row.commitment():
            return PartOutcome(fault=FaultKind.InvalidPart)
        self._row_polys[dealer] = row
        self.our_rows[dealer] = row.evaluate(0)
        values = []
        # one finite-difference sweep over all node indices (PAPERS.md's
        # efficient Shamir share evaluation) instead of n Horner passes
        for j, v in enumerate(_batch.poly_eval_range(row.coeffs,
                                                     len(self.ids))):
            ct = self.pub_keys[self.ids[j]].encrypt(
                v.to_bytes(32, "big"), self.rng
            )
            values.append(ct)
        return PartOutcome(ack=Ack(dealer, tuple(values)))

    def handle_ack(self, sender_id: NodeId, ack: Ack) -> AckOutcome:
        """Validate an Ack against the dealer's commitment and count it."""
        if sender_id not in self.ids:
            return AckOutcome(fault=FaultKind.UnknownSender)
        acker = self.ids.index(sender_id)
        dealer = ack.proposer_index
        if dealer not in self.parts:
            return AckOutcome(fault=FaultKind.InvalidAck)
        if len(ack.values) != len(self.ids):
            return AckOutcome(fault=FaultKind.InvalidAck)
        if acker in self.acks.get(dealer, set()):
            return AckOutcome()  # duplicate — idempotent
        if self.our_index is not None:
            val_bytes = self.secret_key.decrypt(ack.values[self.our_index])
            if val_bytes is None or len(val_bytes) != 32:
                return AckOutcome(fault=FaultKind.InvalidAck)
            v = int.from_bytes(val_bytes, "big")
            # g1^v must equal commitment_d(acker+1, our+1)
            from hbbft_tpu_torch.crypto import batch as _batch
            from hbbft_tpu_torch.crypto import bls12_381 as bls

            expect = _batch.commitment_eval(
                self.parts[dealer], acker + 1, self.our_index + 1,
                device=self.device,
            )
            if not bls.g1_eq(bls.g1_mul(bls.G1_GEN, v), expect):
                return AckOutcome(fault=FaultKind.InvalidAck)
        # hblint: disable=bounded-ingress (dealer and acker are validator
        # indices: both dimensions are capped by the node count)
        self.acks.setdefault(dealer, set()).add(acker)
        return AckOutcome()

    # -- completion ----------------------------------------------------------

    def _complete_dealers(self) -> List[int]:
        need = 2 * self.threshold + 1
        return sorted(
            d for d, ackers in self.acks.items() if len(ackers) >= need
        )

    def count_complete(self) -> int:
        return len(self._complete_dealers())

    def is_ready(self) -> bool:
        """t+1 complete Parts → at least one honest dealer contributed."""
        return self.count_complete() >= self.threshold + 1

    def generate(self) -> Tuple[tc.PublicKeySet, Optional[tc.SecretKeyShare]]:
        """Sum the complete dealers into the final key material.

        Reference: ``generate() → (PublicKeySet, Option<SecretKeyShare>)``.
        """
        dealers = self._complete_dealers()
        if len(dealers) < self.threshold + 1:
            raise ValueError("DKG not ready")
        com: Optional[tc.Commitment] = None
        for d in dealers:
            row0 = self.parts[d].row(0)
            com = row0 if com is None else com + row0
        sk_share = None
        if self.our_index is not None:
            missing = [d for d in dealers if d not in self.our_rows]
            if not missing:
                total = sum(self.our_rows[d] for d in dealers) % tc.R
                sk_share = tc.SecretKeyShare(total)
        return tc.PublicKeySet(com), sk_share

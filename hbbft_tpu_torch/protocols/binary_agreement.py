"""Binary agreement (ABA) — Mostéfaoui–Moumen–Raynal, signature-free rounds
with a threshold-signature common coin.

Reference: ``src/binary_agreement/`` — ``binary_agreement.rs`` (the epoch
loop), ``sbv_broadcast.rs`` (the BVal/Aux "synchronized binary value"
sub-protocol), ``bool_set.rs`` (we use ``frozenset`` of bools).

Per epoch: nodes BVal-broadcast their estimate; f+1 matching BVals trigger a
relay, 2f+1 admit the value into ``bin_values`` and trigger one Aux; N−f Aux
messages whose values are all in ``bin_values`` close SBV with the supported
value set ``vals``.  A Conf round (N−f Confs with sets ⊆ bin_values) guards
the coin flip.  Then the common coin (fixed true/false for the first two of
every three epochs — the Moumen schedule that defeats the MITM delay attack —
and a ``ThresholdSign`` coin every third): if ``vals == {coin}`` decide;
if ``vals`` is a singleton, carry it as the next estimate; else adopt the
coin.  Decided nodes broadcast ``Term(b)``, which substitutes for their
BVal/Aux/Conf in all later epochs; f+1 ``Term(b)`` is itself a decision.

The port's copy of the JAX package's module (host work only: the coin's
signature shares are checked on the host by ``ThresholdSign``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, FrozenSet, Hashable, List, Optional, Set, Tuple

from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSign, ThresholdSignMessage
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

NodeId = Hashable

BoolSet = FrozenSet[bool]
NONE: BoolSet = frozenset()
BOTH: BoolSet = frozenset((True, False))

#: legitimate distinct messages per future epoch per sender (2×BVal,
#: 2×Aux, Conf, Coin, slack): the per-sender future-buffer cap is
#: ``FUTURE_CAP_PER_EPOCH * (max_future_epochs + 1)`` — shared with the
#: chaos campaign's guard witness so the asserted bound can never
#: silently diverge from the enforced one
FUTURE_CAP_PER_EPOCH = 8
DEFAULT_MAX_FUTURE_EPOCHS = 16


# -- messages (reference: binary_agreement message.rs) ----------------------


@dataclass(frozen=True)
class BValMsg:
    epoch: int
    value: bool


@dataclass(frozen=True)
class AuxMsg:
    epoch: int
    value: bool


@dataclass(frozen=True)
class ConfMsg:
    epoch: int
    values: BoolSet


@dataclass(frozen=True)
class TermMsg:
    value: bool


@dataclass(frozen=True)
class CoinMsg:
    epoch: int
    msg: ThresholdSignMessage


class SbvBroadcast:
    """Synchronized binary value broadcast (one instance per ABA epoch).

    Reference: ``src/binary_agreement/sbv_broadcast.rs``.
    Message emission is returned as (to_send, step) where ``to_send`` lists
    ('bval'|'aux', bool) broadcasts for the owner to wrap with epoch tags.
    """

    def __init__(self, n: int, f: int):
        self.n = n
        self.f = f
        self.bval_received: Dict[bool, Set[NodeId]] = {True: set(), False: set()}
        self.aux_received: Dict[bool, Set[NodeId]] = {True: set(), False: set()}
        self.bval_sent: Set[bool] = set()
        self.aux_sent = False
        self.bin_values: Set[bool] = set()
        self.output: Optional[BoolSet] = None

    def send_bval(self, value: bool) -> List[Tuple[str, bool]]:
        if value in self.bval_sent:
            return []
        self.bval_sent.add(value)
        return [("bval", value)]

    def handle_bval(
        self, sender: NodeId, value: bool
    ) -> Tuple[List[Tuple[str, bool]], Optional[FaultKind]]:
        if sender in self.bval_received[value]:
            # Same-value repeat: benign, NOT evidence.  A Term legitimately
            # substitutes for its sender's BVal/Aux (see _handle_term), so
            # under reordering an honest node's genuine BVal can arrive
            # after its Term already seeded these sets — faulting repeats
            # would accuse honest nodes.  (The reference's DuplicateBVal
            # fault kind is therefore intentionally not reproduced.)
            return [], None
        self.bval_received[value].add(sender)
        out: List[Tuple[str, bool]] = []
        count = len(self.bval_received[value])
        if count >= self.f + 1 and value not in self.bval_sent:
            # hblint: disable=bounded-ingress (a set of BOOLS: the value
            # domain caps it at two members)
            self.bval_sent.add(value)
            out.append(("bval", value))
        if count >= 2 * self.f + 1 and value not in self.bin_values:
            # hblint: disable=bounded-ingress (same two-member bool set)
            self.bin_values.add(value)
            if not self.aux_sent:
                self.aux_sent = True
                out.append(("aux", value))
        return out, None

    def handle_aux(
        self, sender: NodeId, value: bool
    ) -> Optional[FaultKind]:
        if sender in self.aux_received[value]:
            return None  # benign repeat — see handle_bval
        self.aux_received[value].add(sender)
        return None

    def try_output(self) -> Optional[BoolSet]:
        """vals = the set of aux-supported bin_values once support ≥ N−f."""
        if not self.bin_values:
            return None
        senders: Set[NodeId] = set()
        vals: Set[bool] = set()
        for v in self.bin_values:
            if self.aux_received[v]:
                vals.add(v)
                senders |= self.aux_received[v]
        # only count aux from senders whose value ∈ bin_values
        if len(senders) >= self.n - self.f and vals:
            self.output = frozenset(vals)
            return self.output
        return None


class BinaryAgreement(ConsensusProtocol):
    """Reference: ``src/binary_agreement/binary_agreement.rs``."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        session_id: bytes,
        proposer_id: NodeId,
        max_future_epochs: int = DEFAULT_MAX_FUTURE_EPOCHS,
    ):
        self.netinfo = netinfo
        self.session_id = bytes(session_id)
        self.proposer_id = proposer_id
        self.n = netinfo.num_nodes()
        self.f = netinfo.num_faulty()
        self.epoch = 0
        self.estimate: Optional[bool] = None
        self.decision: Optional[bool] = None
        self.sbv = SbvBroadcast(self.n, self.f)
        self.conf_round = False
        self.conf_vals: Optional[BoolSet] = None
        self.conf_received: Dict[NodeId, BoolSet] = {}
        self.coin: Optional[ThresholdSign] = None
        self.coin_value: Optional[bool] = None
        self.terms: Dict[NodeId, bool] = {}
        self.term_sent = False
        # future-epoch buffer: deduplicated, bounded per sender (≤ ~8
        # distinct messages per epoch are legitimate: 2×BVal, 2×Aux, Conf,
        # Coin, slack) so one Byzantine peer cannot grow memory unboundedly.
        # Overflow is a counted EPOCH-PRIORITY eviction of the offending
        # sender's own entries (never another peer's): the sender's
        # farthest-future message goes first, because the lowest-epoch
        # entries are the ones the protocol will need soonest.
        self.future: Set[Tuple[NodeId, object]] = set()
        self.max_future_epochs = max_future_epochs
        self.future_cap_per_sender = (
            FUTURE_CAP_PER_EPOCH * (max_future_epochs + 1))
        self.future_evictions: Dict[NodeId, int] = {}
        # run-long high-water mark of any single sender's buffered
        # entries, recorded BEFORE eviction — a working cap keeps this
        # ≤ cap + 1 (the just-inserted entry), and a broken eviction
        # shows up as a growing peak.  (A post-eviction reading would
        # hold ≤ cap by construction and could never fail.)
        self.future_peak = 0

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return self.decision is not None

    def handle_input(self, input: bool) -> Step:
        if self.estimate is not None or self.decision is not None:
            return Step()
        self.estimate = bool(input)
        return self._broadcast_sbv(self.sbv.send_bval(self.estimate))

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            return Step.from_fault(sender_id, FaultKind.UnknownSender)
        if self.decision is not None:
            return Step()
        if isinstance(message, TermMsg):
            return self._handle_term(sender_id, message.value)
        ep = message.epoch
        if ep < self.epoch:
            return Step()  # obsolete
        if ep > self.epoch:
            if ep > self.epoch + self.max_future_epochs:
                return Step.from_fault(
                    sender_id, FaultKind.AgreementEpochMismatch
                )
            entry = (sender_id, message)
            if entry not in self.future:
                self.future.add(entry)
                mine = [e for e in self.future if e[0] == sender_id]
                if len(mine) > self.future_peak:
                    self.future_peak = len(mine)  # pre-evict, on purpose
                if len(mine) > self.future_cap_per_sender:
                    # counted epoch-priority eviction of the SPAMMER's
                    # own farthest-future entry (which may be the one
                    # just admitted) — deterministic victim choice so
                    # the simulator's byte-identity replays hold
                    victim = max(
                        mine,
                        key=lambda e: (getattr(e[1], "epoch", 0),
                                       repr(e[1])),
                    )
                    self.future.discard(victim)
                    self.future_evictions[sender_id] = (
                        self.future_evictions.get(sender_id, 0) + 1
                    )
                    return Step.from_fault(
                        sender_id, FaultKind.AgreementEpochMismatch
                    )
            return Step()
        return self._handle_current(sender_id, message)

    # -- epoch machinery -----------------------------------------------------

    def _handle_current(self, sender_id: NodeId, message) -> Step:
        step = Step()
        if isinstance(message, BValMsg):
            out, fault = self.sbv.handle_bval(sender_id, message.value)
            if fault:
                return Step.from_fault(sender_id, fault)
            step.extend(self._broadcast_sbv(out))
        elif isinstance(message, AuxMsg):
            fault = self.sbv.handle_aux(sender_id, message.value)
            if fault:
                return Step.from_fault(sender_id, fault)
        elif isinstance(message, ConfMsg):
            if sender_id in self.conf_received:
                if self.conf_received[sender_id] == message.values:
                    return Step()  # network replay — idempotent
                return Step.from_fault(sender_id, FaultKind.MultipleConf)
            self.conf_received[sender_id] = message.values
        elif isinstance(message, CoinMsg):
            if self.coin is None:
                self._make_coin()
            ts_step = self.coin.handle_message(sender_id, message.msg).map(
                lambda m: CoinMsg(self.epoch, m)
            )
            ts_step.output.clear()  # the Signature is consumed via coin state
            step.extend(ts_step)
        else:
            raise TypeError(f"unknown BA message {message!r}")
        step.extend(self._progress())
        return step

    def _progress(self) -> Step:
        """Drive the epoch pipeline: SBV → Conf → coin → update/decide."""
        step = Step()
        if self.decision is not None:
            return step
        if self.conf_vals is None:
            vals = self.sbv.try_output()
            if vals is None:
                return step
            self.conf_vals = vals
            step.send_all(ConfMsg(self.epoch, vals))
            step.extend(self._handle_conf_self(vals))
            return step.extend(self._progress())
        # conf round: count confs with values ⊆ bin_values (+Term senders)
        count = sum(
            1
            for v in self.conf_received.values()
            if v <= frozenset(self.sbv.bin_values)
        )
        if count < self.n - self.f:
            return step
        # flip/invoke the coin
        if self.coin_value is None:
            sched = self._coin_schedule()
            if sched == "true":
                self.coin_value = True
            elif sched == "false":
                self.coin_value = False
            else:
                if self.coin is None:
                    self._make_coin()
                if not self.coin.had_input:
                    ts_step = self.coin.sign().map(
                        lambda m: CoinMsg(self.epoch, m)
                    )
                    ts_step.output.clear()
                    step.extend(ts_step)
                if self.coin.signature is None:
                    return step
                self.coin_value = self.coin.signature.parity()
        return step.extend(self._apply_coin())

    def _handle_conf_self(self, vals: BoolSet) -> Step:
        self.conf_received[self.our_id()] = vals
        return Step()

    def _apply_coin(self) -> Step:
        """MMR decision rule on our SBV value set ``vals`` and the coin:
        vals == {coin} → decide; singleton {v} → carry v; BOTH → adopt coin."""
        coin = self.coin_value
        vals = self.conf_vals
        step = Step()
        if vals == frozenset((coin,)):
            return step.extend(self._decide(coin))
        if len(vals) == 1:
            (est,) = vals
        else:
            est = coin
        return step.extend(self._next_epoch(est))

    def _next_epoch(self, est: bool) -> Step:
        self.epoch += 1
        self.sbv = SbvBroadcast(self.n, self.f)
        self.conf_vals = None
        self.conf_received = {}
        self.coin = None
        self.coin_value = None
        self.estimate = est
        step = Step()
        # decided peers participate via their recorded Terms
        for nid, b in self.terms.items():
            self.sbv.bval_received[b].add(nid)
            self.sbv.aux_received[b].add(nid)
            self.conf_received[nid] = frozenset((b,))
        step.extend(self._broadcast_sbv(self.sbv.send_bval(est)))
        # replay queued future-epoch messages for this epoch
        future, self.future = self.future, set()
        for sender, msg in sorted(future, key=repr):
            if getattr(msg, "epoch", None) == self.epoch:
                step.extend(self._handle_current(sender, msg))
            else:
                self.future.add((sender, msg))
        return step

    def _decide(self, b: bool) -> Step:
        if self.decision is not None:
            return Step()
        self.decision = b
        step = Step.from_output(b)
        if not self.term_sent:
            self.term_sent = True
            step.send_all(TermMsg(b))
        return step

    def _handle_term(self, sender_id: NodeId, value: bool) -> Step:
        if sender_id in self.terms:
            if self.terms[sender_id] == value:
                return Step()
            return Step.from_fault(sender_id, FaultKind.MultipleTerm)
        self.terms[sender_id] = value
        step = Step()
        # f+1 Terms for b: safe to decide b
        if sum(1 for v in self.terms.values() if v == value) >= self.f + 1:
            return step.extend(self._decide(value))
        # a Term also acts as BVal+Aux+Conf for the current epoch
        out, _ = self.sbv.handle_bval(sender_id, value)
        step.extend(self._broadcast_sbv(out))
        self.sbv.handle_aux(sender_id, value)
        self.conf_received.setdefault(sender_id, frozenset((value,)))
        step.extend(self._progress())
        return step

    def _broadcast_sbv(self, out: List[Tuple[str, bool]]) -> Step:
        """Send queued SBV broadcasts and loop them back to ourselves."""
        step = Step()
        for kind, value in out:
            if kind == "bval":
                step.send_all(BValMsg(self.epoch, value))
                o2, _ = self.sbv.handle_bval(self.our_id(), value)
                step.extend(self._broadcast_sbv(o2))
            else:
                step.send_all(AuxMsg(self.epoch, value))
                self.sbv.handle_aux(self.our_id(), value)
        if out:
            step.extend(self._progress())
        return step

    # -- coin ----------------------------------------------------------------

    def _coin_schedule(self) -> str:
        """Moumen schedule: epochs 0,1 mod 3 are fixed, every third is random.

        Reference: the coin-schedule optimization in
        ``binary_agreement.rs`` (defeats the MITM delay attack of
        ``tests/binary_agreement_mitm.rs`` while saving two coin flips in
        three).
        """
        m = self.epoch % 3
        if m == 0:
            return "true"
        if m == 1:
            return "false"
        return "random"

    def _make_coin(self) -> None:
        nonce = (
            b"HBBFT-ABA-COIN"
            + struct.pack(">I", len(self.session_id))
            + self.session_id
            + repr(self.proposer_id).encode()
            + struct.pack(">Q", self.epoch)
        )
        self.coin = ThresholdSign(self.netinfo)
        self.coin.set_document(nonce)

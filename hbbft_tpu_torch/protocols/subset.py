"""Asynchronous common subset (ACS).

Reference: ``src/subset/{subset.rs, proposal_state.rs}`` — runs one
``Broadcast`` and one ``BinaryAgreement`` per proposer.  BA_j gets input
``true`` as soon as RBC_j delivers; once N−f BAs have decided ``true``,
``false`` is input to every undecided BA.  The output is the set of
contributions whose BA decided ``true`` (each emitted incrementally as
``SubsetOutput.Contribution``), followed by ``SubsetOutput.Done`` when all
BAs have decided and all accepted values are in.

All correct nodes output the same ≥ N−f proposal set.

The port's copy of the JAX package's module; ``device`` goes to every
``Broadcast`` (its erasure code under the ``device`` backend).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Hashable, Optional

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols.binary_agreement import BinaryAgreement
from hbbft_tpu_torch.protocols.broadcast import Broadcast
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

NodeId = Hashable


# -- messages (reference: Message::{Broadcast, Agreement}) -------------------


@dataclass(frozen=True)
class BroadcastWrap:
    proposer_id: NodeId
    msg: object


@dataclass(frozen=True)
class AgreementWrap:
    proposer_id: NodeId
    msg: object


class SubsetHandlingStrategy(enum.Enum):
    """When accepted contributions are released to the caller.

    Reference: ``src/subset/ :: SubsetHandlingStrategy`` (builder knob,
    [MED]).  ``Incremental`` emits each ``Contribution`` as soon as its BA
    decides true and the value is in hand (lower latency for callers that
    can start work per-contribution, e.g. spawning threshold-decrypts);
    ``AllAtEnd`` withholds them and emits the entire accepted set
    immediately before ``Done`` (single completion event).
    The decided *set* is identical either way.
    """

    Incremental = "incremental"
    AllAtEnd = "all_at_end"


# -- outputs (reference: SubsetOutput) ---------------------------------------


@dataclass(frozen=True)
class Contribution:
    proposer_id: NodeId
    value: bytes


@dataclass(frozen=True)
class Done:
    pass


class _ProposalState:
    """Reference: ``src/subset/proposal_state.rs :: ProposalState``."""

    def __init__(self, broadcast: Broadcast, agreement: BinaryAgreement):
        self.broadcast = broadcast
        self.agreement = agreement
        self.value: Optional[bytes] = None
        self.decision: Optional[bool] = None
        self.emitted = False


class Subset(ConsensusProtocol):
    """Reference: ``src/subset/subset.rs :: Subset<N, S>``."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        session_id: bytes,
        handling_strategy: SubsetHandlingStrategy = (
            SubsetHandlingStrategy.Incremental
        ),
        device="cuda",
    ):
        self.netinfo = netinfo
        self.device = resolve_device(device)
        self.session_id = bytes(session_id)
        self.handling_strategy = handling_strategy
        self.proposals: Dict[NodeId, _ProposalState] = {}
        for pid in netinfo.all_ids():
            ba_session = self.session_id + b"/ba/" + repr(pid).encode()
            self.proposals[pid] = _ProposalState(
                Broadcast(netinfo, pid, device=self.device),
                BinaryAgreement(netinfo, ba_session, pid),
            )
        self.done = False
        self.false_inputs_sent = False
        # Per-sender message budget for this ONE ACS instance (overload
        # defense): honest traffic per sender is a few messages per
        # proposer for RBC plus ~6 per ABA round — even a long
        # coin-fought ABA stays well under this.  Past the budget a
        # sender's messages are dropped with a counted fault; the
        # count state is bounded by the validator set.
        self.msg_budget_per_sender = 4096 * max(1, netinfo.num_nodes())
        self._msg_counts: Dict[NodeId, int] = {}
        self.flood_drops: Dict[NodeId, int] = {}

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return self.done

    def handle_input(self, input: bytes) -> Step:
        """Propose our contribution via our own broadcast instance."""
        prop = self.proposals[self.our_id()]
        inner = prop.broadcast.handle_input(input)
        return self._process_broadcast_step(self.our_id(), inner)

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            return Step.from_fault(sender_id, FaultKind.UnknownSender)
        count = self._msg_counts.get(sender_id, 0) + 1
        if count > self.msg_budget_per_sender:
            self.flood_drops[sender_id] = (
                self.flood_drops.get(sender_id, 0) + 1
            )
            return Step.from_fault(sender_id, FaultKind.SubsetMessageFlood)
        self._msg_counts[sender_id] = count
        if isinstance(message, BroadcastWrap):
            prop = self.proposals.get(message.proposer_id)
            if prop is None:
                return Step.from_fault(sender_id, FaultKind.InvalidSubsetMessage)
            inner = prop.broadcast.handle_message(sender_id, message.msg)
            return self._process_broadcast_step(message.proposer_id, inner)
        if isinstance(message, AgreementWrap):
            prop = self.proposals.get(message.proposer_id)
            if prop is None:
                return Step.from_fault(sender_id, FaultKind.InvalidSubsetMessage)
            inner = prop.agreement.handle_message(sender_id, message.msg)
            return self._process_agreement_step(message.proposer_id, inner)
        raise TypeError(f"unknown subset message {message!r}")

    # -- internals -----------------------------------------------------------

    def _process_broadcast_step(self, proposer_id: NodeId, inner: Step) -> Step:
        prop = self.proposals[proposer_id]
        step = inner.map(lambda m: BroadcastWrap(proposer_id, m))
        values = step.output
        step.output = []
        changed = False
        for value in values:
            if prop.value is None:
                prop.value = value
                changed = True
                # RBC delivered → vote to accept this proposal
                if prop.decision is None and prop.agreement.estimate is None:
                    ba_step = prop.agreement.handle_input(True)
                    step.extend(
                        self._process_agreement_step(proposer_id, ba_step)
                    )
        if not changed:
            # no new delivery → emission/threshold/Done state cannot have
            # moved: skip the all-proposals _try_progress scan (it runs
            # once per consensus message otherwise)
            return step
        return step.extend(self._try_progress())

    def _process_agreement_step(self, proposer_id: NodeId, inner: Step) -> Step:
        prop = self.proposals[proposer_id]
        step = inner.map(lambda m: AgreementWrap(proposer_id, m))
        decisions = step.output
        step.output = []
        changed = False
        for d in decisions:
            if prop.decision is None:
                prop.decision = bool(d)
                changed = True
        if not changed:
            return step
        return step.extend(self._try_progress())

    def _count_true(self) -> int:
        return sum(1 for p in self.proposals.values() if p.decision is True)

    def _try_progress(self) -> Step:
        if self.done:
            return Step()
        step = Step()
        n, f = self.netinfo.num_nodes(), self.netinfo.num_faulty()
        # emit newly-available accepted contributions (AllAtEnd withholds
        # them until the Done edge below)
        if self.handling_strategy is SubsetHandlingStrategy.Incremental:
            for pid in self.netinfo.all_ids():
                prop = self.proposals[pid]
                if (
                    prop.decision is True
                    and prop.value is not None
                    and not prop.emitted
                ):
                    prop.emitted = True
                    step.output.append(Contribution(pid, prop.value))
        # N−f accepted → vote false on the rest
        if self._count_true() >= n - f and not self.false_inputs_sent:
            self.false_inputs_sent = True
            for pid in self.netinfo.all_ids():
                prop = self.proposals[pid]
                if prop.decision is None and prop.agreement.estimate is None:
                    ba_step = prop.agreement.handle_input(False)
                    step.extend(
                        self._process_agreement_step(pid, ba_step)
                    )
        # all decided and all accepted values in hand → Done
        # (re-check self.done: a nested _try_progress via the false-input
        # loop may already have emitted it)
        all_decided = all(
            p.decision is not None for p in self.proposals.values()
        )
        if self.handling_strategy is SubsetHandlingStrategy.Incremental:
            complete = all(
                p.emitted or p.decision is False
                for p in self.proposals.values()
            )
        else:  # AllAtEnd: accepted values present, none emitted yet
            complete = all(
                p.decision is False or p.value is not None
                for p in self.proposals.values()
            )
        if not self.done and all_decided and complete:
            self.done = True
            if self.handling_strategy is SubsetHandlingStrategy.AllAtEnd:
                for pid in self.netinfo.all_ids():
                    prop = self.proposals[pid]
                    if prop.decision is True and not prop.emitted:
                        prop.emitted = True
                        step.output.append(Contribution(pid, prop.value))
            step.output.append(Done())
        return step

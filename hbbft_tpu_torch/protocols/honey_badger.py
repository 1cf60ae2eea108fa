"""HoneyBadger atomic broadcast: the epoch loop.

Reference: ``src/honey_badger/`` — ``honey_badger.rs`` (epoch window +
message routing), ``epoch_state.rs`` (one ``Subset`` + per-proposer
``ThresholdDecrypt``), ``batch.rs``, ``builder.rs``, ``message.rs``.

Per epoch: each node TPKE-encrypts its serialized contribution under the
network's threshold public key (per the ``EncryptionSchedule``), proposes the
ciphertext into that epoch's ``Subset``; when the ACS delivers the agreed
ciphertext set, every validator publishes a decryption share per accepted
ciphertext; t+1 shares decrypt each one, and the epoch closes with a
``Batch`` of (proposer → contribution bytes), identical on every correct
node and in epoch order.

Contribution payloads here are opaque bytes; ``DynamicHoneyBadger``/
``QueueingHoneyBadger`` own (de)serialization (the reference uses bincode at
this boundary and faults ``BatchDeserializationFailed``; our equivalent
fault is raised there).

The port's copy of the JAX package's module.  One ``device`` (the builder's
``.device()``, default ``"cuda"``, raising without a card) reaches every
seam of ``crypto/batch.py`` and the erasure code: ``_precheck_accepted``
(decryption-share generation), ``resolve_deferred`` (merged share-set
checks), each ``ThresholdDecrypt`` (share-set folds) and each
``Broadcast``'s coder (through the ``Subset``).
"""

from __future__ import annotations

import random
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.crypto import tc
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols import subset as subset_mod
from hbbft_tpu_torch.protocols.subset import Subset, SubsetHandlingStrategy
from hbbft_tpu_torch.protocols.threshold_decrypt import (
    DecryptionMessage,
    ThresholdDecrypt,
)
from hbbft_tpu_torch.traits import ConsensusProtocol, Step

NodeId = Hashable


# -- encryption schedule (reference: EncryptionSchedule) ---------------------


class EncryptionSchedule:
    """When to TPKE-encrypt contributions.

    Reference variants: ``Always``, ``Never``, ``EveryNthEpoch(n)``,
    ``TickTock(on, off)``.
    """

    def __init__(self, kind: str, a: int = 0, b: int = 0):
        self.kind = kind
        self.a = a
        self.b = b

    @classmethod
    def always(cls):
        return cls("always")

    @classmethod
    def never(cls):
        return cls("never")

    @classmethod
    def every_nth_epoch(cls, n: int):
        return cls("nth", n)

    @classmethod
    def tick_tock(cls, on: int, off: int):
        return cls("ticktock", on, off)

    def encrypt_on_epoch(self, epoch: int) -> bool:
        if self.kind == "always":
            return True
        if self.kind == "never":
            return False
        if self.kind == "nth":
            return epoch % self.a == 0
        period = self.a + self.b
        return (epoch % period) < self.a


# -- messages ---------------------------------------------------------------


@dataclass(frozen=True)
class SubsetWrap:
    epoch: int
    msg: object


@dataclass(frozen=True)
class DecryptionShareWrap:
    epoch: int
    proposer_id: NodeId
    msg: DecryptionMessage


# -- batch ------------------------------------------------------------------


@dataclass(frozen=True)
class Batch:
    """Reference: ``src/honey_badger/batch.rs :: Batch<C, N>``."""

    epoch: int
    contributions: Tuple[Tuple[NodeId, bytes], ...]

    def contributions_map(self) -> Dict[NodeId, bytes]:
        return dict(self.contributions)

    def is_empty(self) -> bool:
        return not self.contributions


# -- epoch state ------------------------------------------------------------

_PLAIN = 0x00
_ENCRYPTED = 0x01


class _EpochState:
    """Reference: ``src/honey_badger/epoch_state.rs :: EpochState``."""

    def __init__(self, netinfo: NetworkInfo, session_id: bytes, epoch: int,
                 subset_handling_strategy=None, device="cuda"):
        self.netinfo = netinfo
        self.epoch = epoch
        self.subset = Subset(
            netinfo, session_id + b"/hb-epoch/" + struct.pack(">Q", epoch),
            handling_strategy=(
                subset_handling_strategy or SubsetHandlingStrategy.Incremental
            ),
            device=device,
        )
        self.decrypts: Dict[NodeId, ThresholdDecrypt] = {}
        self.plain: Dict[NodeId, bytes] = {}
        self.excluded: set = set()
        self.subset_done = False
        self.accepted: set = set()

    def decrypted_all(self) -> bool:
        return self.subset_done and all(
            pid in self.plain or pid in self.excluded for pid in self.accepted
        )

    def batch(self) -> Batch:
        return Batch(
            epoch=self.epoch,
            contributions=tuple(
                sorted(self.plain.items(), key=lambda kv: repr(kv[0]))
            ),
        )


class HoneyBadgerBuilder:
    """Reference: ``src/honey_badger/builder.rs``."""

    def __init__(self, netinfo: NetworkInfo):
        self.netinfo = netinfo
        self._session_id = b"hb"
        self._max_future_epochs = 3
        self._encryption_schedule = EncryptionSchedule.always()
        self._subset_handling_strategy = None
        self._rng: Optional[random.Random] = None
        self._device = "cuda"

    def session_id(self, sid: bytes) -> "HoneyBadgerBuilder":
        self._session_id = bytes(sid)
        return self

    def max_future_epochs(self, n: int) -> "HoneyBadgerBuilder":
        self._max_future_epochs = n
        return self

    def encryption_schedule(self, es: EncryptionSchedule) -> "HoneyBadgerBuilder":
        self._encryption_schedule = es
        return self

    def rng(self, rng: random.Random) -> "HoneyBadgerBuilder":
        self._rng = rng
        return self

    def subset_handling_strategy(self, s) -> "HoneyBadgerBuilder":
        """Reference: ``HoneyBadgerBuilder::subset_handling_strategy``."""
        self._subset_handling_strategy = s
        return self

    def device(self, device) -> "HoneyBadgerBuilder":
        """Where the crypto batches and the ``device`` erasure backend run
        (default ``"cuda"``; ``build`` raises without a card)."""
        self._device = device
        return self

    def build(self) -> "HoneyBadger":
        return HoneyBadger(
            self.netinfo,
            session_id=self._session_id,
            max_future_epochs=self._max_future_epochs,
            encryption_schedule=self._encryption_schedule,
            rng=self._rng or random.Random(0),
            subset_handling_strategy=self._subset_handling_strategy,
            device=self._device,
        )


class HoneyBadger(ConsensusProtocol):
    """Reference: ``src/honey_badger/honey_badger.rs :: HoneyBadger<C, N>``."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        session_id: bytes = b"hb",
        max_future_epochs: int = 3,
        encryption_schedule: Optional[EncryptionSchedule] = None,
        rng: Optional[random.Random] = None,
        subset_handling_strategy=None,
        device="cuda",
    ):
        self.netinfo = netinfo
        self.device = resolve_device(device)
        self.session_id = bytes(session_id)
        self.epoch = 0
        self.max_future_epochs = max_future_epochs
        self.encryption_schedule = encryption_schedule or EncryptionSchedule.always()
        self.rng = rng or random.Random(0)
        self.subset_handling_strategy = subset_handling_strategy
        self.epochs: Dict[int, _EpochState] = {}
        self.has_input: Dict[int, bool] = {}
        self.completed: Dict[int, Batch] = {}
        # Deferred threshold-decrypt verification (the epoch-pipelined
        # runtime's cross-epoch crypto seam): when True, every
        # ThresholdDecrypt this instance creates parks its t+1 share-set
        # verification here instead of pairing inline; the pump drains
        # them via resolve_deferred() as ONE merged device/pairing call
        # per iteration.  False (default) keeps the simulator-exact path.
        self.defer_decrypt = False
        self._deferred_decrypts: List[Tuple[int, NodeId, Any]] = []
        # Per-sender future-epoch admission budget (overload defense):
        # a Byzantine validator spamming protocol messages at the
        # `epoch + max_future_epochs` window edge forces future epoch
        # states open and churns their sub-protocols.  Honest pipelined
        # traffic between two epoch advances is well under ~100 messages
        # per sender per future epoch at any tested topology; beyond the
        # budget the sender's messages for epochs ahead of the current
        # one are dropped with a counted FutureEpochFlood fault.  Counts
        # reset every time the current epoch advances (the window slid).
        self.future_msg_budget = 256 * (max_future_epochs + 1)
        self._future_counts: Dict[NodeId, int] = {}
        self.future_drops: Dict[NodeId, int] = {}
        # guard statistics folded from CLOSED epochs (their Subset/BA
        # instances are deleted with the epoch state — without this a
        # run-long "peak stayed ≤ cap" witness would silently lose
        # every epoch that completed before it was read)
        self.closed_guard: Dict[str, int] = {
            "aba_future_peak": 0,
            "aba_future_evictions": 0,
            "subset_flood_drops": 0,
        }

    @classmethod
    def builder(cls, netinfo: NetworkInfo) -> HoneyBadgerBuilder:
        return HoneyBadgerBuilder(netinfo)

    # -- ConsensusProtocol ---------------------------------------------------

    def our_id(self) -> NodeId:
        return self.netinfo.our_id()

    def terminated(self) -> bool:
        return False  # atomic broadcast runs forever

    def next_epoch(self) -> int:
        return self.epoch

    def handle_input(self, input: bytes) -> Step:
        return self.propose(input)

    def propose(self, contribution: bytes) -> Step:
        """Encrypt (per schedule) and propose into the current epoch's ACS.

        Reference: ``HoneyBadger::propose`` (HOT: TPKE encrypt —
        G1/G2 scalar muls).
        """
        return self.propose_into(self.epoch, contribution)

    def propose_into(self, epoch: int, contribution: bytes) -> Step:
        """Propose into ``epoch`` — the current one (``propose``) or a
        future one within the ``max_future_epochs`` window.

        This is the epoch-pipelining seam: the protocol already accepts
        peers' messages up to ``max_future_epochs`` ahead, so a proposer
        may open epoch e+k's Subset while epoch e is still threshold-
        decrypting.  Out-of-window or already-proposed epochs are no-ops.
        """
        if epoch < self.epoch or epoch > self.epoch + self.max_future_epochs:
            return Step()
        if self.has_input.get(epoch):
            return Step()
        self.has_input[epoch] = True
        if self.encryption_schedule.encrypt_on_epoch(epoch):
            ct = (
                self.netinfo.public_key_set()
                .public_key()
                .encrypt(bytes(contribution), self.rng)
            )
            payload = bytes([_ENCRYPTED]) + ct.to_bytes()
        else:
            payload = bytes([_PLAIN]) + bytes(contribution)
        state = self._epoch_state(epoch)
        inner = state.subset.handle_input(payload)
        return self._process_subset_step(epoch, inner)

    def handle_message(self, sender_id: NodeId, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            return Step.from_fault(sender_id, FaultKind.UnknownSender)
        epoch = message.epoch
        if epoch < self.epoch:
            return Step()  # obsolete epoch
        if epoch > self.epoch + self.max_future_epochs:
            return Step.from_fault(sender_id, FaultKind.UnexpectedHbMessage)
        if epoch > self.epoch:
            count = self._future_counts.get(sender_id, 0) + 1
            if count > self.future_msg_budget:
                self.future_drops[sender_id] = (
                    self.future_drops.get(sender_id, 0) + 1
                )
                return Step.from_fault(sender_id,
                                       FaultKind.FutureEpochFlood)
            self._future_counts[sender_id] = count
        if isinstance(message, SubsetWrap):
            state = self._epoch_state(epoch)
            inner = state.subset.handle_message(sender_id, message.msg)
            return self._process_subset_step(epoch, inner)
        if isinstance(message, DecryptionShareWrap):
            if not self.netinfo.is_node_validator(message.proposer_id):
                # unknown proposer: reject before creating any state
                return Step.from_fault(
                    sender_id, FaultKind.UnexpectedDecryptionShare
                )
            state = self._epoch_state(epoch)
            td = self._decrypt_for(state, message.proposer_id)
            inner = td.handle_message(sender_id, message.msg)
            return self._process_decrypt_step(epoch, message.proposer_id, inner)
        raise TypeError(f"unknown honey_badger message {message!r}")

    # -- internals -----------------------------------------------------------

    def _epoch_state(self, epoch: int) -> _EpochState:
        if epoch not in self.epochs:
            self.epochs[epoch] = _EpochState(
                self.netinfo, self.session_id, epoch,
                subset_handling_strategy=self.subset_handling_strategy,
                device=self.device,
            )
        return self.epochs[epoch]

    def _decrypt_for(self, state: _EpochState, proposer_id: NodeId) -> ThresholdDecrypt:
        if proposer_id not in state.decrypts:
            td = ThresholdDecrypt(self.netinfo, device=self.device)
            if self.defer_decrypt:
                epoch = state.epoch
                td.defer_verify = (
                    lambda inst, e=epoch, p=proposer_id:
                    self._deferred_decrypts.append((e, p, inst))
                )
            state.decrypts[proposer_id] = td
        return state.decrypts[proposer_id]

    # -- deferred threshold-decrypt verification (pipelined pump seam) -------

    def has_deferred(self) -> bool:
        return bool(self._deferred_decrypts)

    def resolve_deferred(self) -> Step:
        """Verify every parked t+1 share set in ONE merged call and resume
        the instances (see ``crypto.batch.verify_dec_share_sets``).  The
        pump calls this at the end of each iteration, so the shares of all
        epochs in flight verify together — cross-epoch batched threshold
        crypto — instead of one pairing check per (epoch, proposer)."""
        if not self._deferred_decrypts:
            return Step()
        from hbbft_tpu_torch.crypto.batch import verify_dec_share_sets

        jobs, self._deferred_decrypts = self._deferred_decrypts, []
        pks = self.netinfo.public_key_set()
        live = []
        for epoch, proposer, td in jobs:
            # an era rotation or epoch close can orphan a parked job —
            # nothing to resume then
            if epoch not in self.epochs or td.deferred_job() is None:
                continue
            live.append((epoch, proposer, td))
        if not live:
            return Step()
        oks = verify_dec_share_sets([
            (pks,) + td.deferred_job() for _e, _p, td in live
        ], device=self.device)
        step = Step()
        for (epoch, proposer, td), ok in zip(live, oks):
            inner = td.finish_deferred(ok)
            step.extend(
                self._process_decrypt_step(epoch, proposer, inner)
            )
        return step

    def _fold_guard(self, state: "_EpochState") -> None:
        """Preserve a closing epoch's overload-guard statistics."""
        g = self.closed_guard
        g["subset_flood_drops"] += sum(
            state.subset.flood_drops.values())
        for prop in state.subset.proposals.values():
            ba = prop.agreement
            if ba.future_peak > g["aba_future_peak"]:
                g["aba_future_peak"] = ba.future_peak
            g["aba_future_evictions"] += sum(
                ba.future_evictions.values())

    def _process_subset_step(self, epoch: int, inner: Step) -> Step:
        step = inner.map(lambda m: SubsetWrap(epoch, m))
        state = self.epochs.get(epoch)
        if state is None:  # epoch already closed mid-step
            step.output = []
            return step
        outputs = step.output
        if not outputs:
            # nothing accepted and Done unchanged → completion state
            # cannot have moved: skip the per-message _try_complete scan
            # (decryption progress runs its own completion check via
            # _process_decrypt_step)
            return step
        step.output = []
        accepted = [
            o for o in outputs if isinstance(o, subset_mod.Contribution)
        ]
        pre = self._precheck_accepted(accepted) if len(accepted) > 1 else {}
        for out in outputs:
            if isinstance(out, subset_mod.Contribution):
                step.extend(
                    self._on_accepted(epoch, out.proposer_id, out.value,
                                      pre.get(out.proposer_id))
                )
            elif isinstance(out, subset_mod.Done):
                state.subset_done = True
        return step.extend(self._try_complete(epoch))

    def _precheck_accepted(self, accepted) -> Dict[NodeId, tuple]:
        """Batch the crypto of several simultaneously ACS-accepted
        ciphertexts: ONE merged CCA pairing check for all of them and ONE
        batched call generating our decryption shares, instead of a
        pairing + a scalar-mul per proposer.  Returns
        ``{proposer: (ct, ok, share)}`` consumed by ``_on_accepted`` —
        verdicts and shares are value-identical to the per-item path, so
        behavior (and the simulator's byte-determinism) is unchanged."""
        from hbbft_tpu_torch.crypto.batch import (
            batch_decrypt_share_gen,
            verify_ciphertext_batch,
        )

        entries = []  # (proposer, ct)
        for out in accepted:
            payload = out.value
            if not payload or payload[0] != _ENCRYPTED:
                continue
            try:
                ct = tc.Ciphertext.from_bytes(payload[1:])
            except (ValueError, IndexError):
                continue
            entries.append((out.proposer_id, ct))
        if not entries:
            return {}
        oks = verify_ciphertext_batch([ct for _p, ct in entries])
        shares: List[Any] = [None] * len(entries)
        if self.netinfo.is_validator():
            valid = [i for i, ok in enumerate(oks) if ok]
            gen = batch_decrypt_share_gen(
                self.netinfo.secret_key_share().scalar,
                [entries[i][1] for i in valid],
                device=self.device,
            )
            for i, share in zip(valid, gen):
                shares[i] = share
        return {
            p: (ct, ok, share)
            for (p, ct), ok, share in zip(entries, oks, shares)
        }

    def _on_accepted(self, epoch: int, proposer_id: NodeId, payload: bytes,
                     pre: Optional[tuple] = None) -> Step:
        """An ACS-accepted contribution: plaintext or ciphertext to decrypt.

        ``pre`` optionally carries this proposer's pre-batched
        ``(ct, verify_ok, our_share)`` from :meth:`_precheck_accepted`.
        """
        state = self.epochs[epoch]
        state.accepted.add(proposer_id)
        step = Step()
        if not payload:
            state.excluded.add(proposer_id)
            return step.fault(proposer_id, FaultKind.InvalidCiphertext)
        tag, body = payload[0], payload[1:]
        if tag == _PLAIN:
            state.plain[proposer_id] = body
            return step
        if tag != _ENCRYPTED:
            state.excluded.add(proposer_id)
            return step.fault(proposer_id, FaultKind.InvalidCiphertext)
        share = None
        if pre is not None:
            ct, ok, share = pre
        else:
            try:
                ct = tc.Ciphertext.from_bytes(body)
                ok = ct.verify()
            except (ValueError, IndexError):
                ok = False
        if not ok:
            # all correct nodes agree (same RBC bytes) → consistent exclusion
            state.excluded.add(proposer_id)
            return step.fault(proposer_id, FaultKind.InvalidCiphertext)
        td = self._decrypt_for(state, proposer_id)
        inner = td.set_ciphertext(ct, share=share)
        return step.extend(self._process_decrypt_step(epoch, proposer_id, inner))

    def _process_decrypt_step(
        self, epoch: int, proposer_id: NodeId, inner: Step
    ) -> Step:
        step = inner.map(
            lambda m: DecryptionShareWrap(epoch, proposer_id, m)
        )
        state = self.epochs.get(epoch)
        if state is None:  # epoch already closed mid-step
            step.output = []
            return step
        outputs = step.output
        step.output = []
        for plaintext in outputs:
            state.plain[proposer_id] = plaintext
        return step.extend(self._try_complete(epoch))

    def _try_complete(self, epoch: int) -> Step:
        """Close completed epochs in order (reference ``update_epoch``)."""
        state = self.epochs.get(epoch)
        if state is None:
            return Step()
        if epoch not in self.completed and state.decrypted_all():
            self.completed[epoch] = state.batch()
        step = Step()
        advanced = False
        while self.epoch in self.completed:
            batch = self.completed.pop(self.epoch)
            step.output.append(batch)
            self._fold_guard(self.epochs[self.epoch])
            del self.epochs[self.epoch]
            self.has_input.pop(self.epoch, None)  # bound per-epoch state
            self.epoch += 1
            advanced = True
        if advanced and self._future_counts:
            # the future window slid: every sender's admission budget
            # renews (state stays bounded by the validator set)
            self._future_counts.clear()
        return step

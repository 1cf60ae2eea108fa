"""Epoch-phase tracing: where did this epoch's latency go?

A :class:`SpanTracer` is a :class:`hbbft_tpu_torch.traits.StepObserver` a driver
(``VirtualNet`` or ``NodeRuntime``) points at one node's message stream.  It
classifies every inbound consensus message by walking the wrapper chain the
protocols already encode (``HbWrap → SubsetWrap → BroadcastWrap → EchoMsg``
…) and aggregates, per ``(era, epoch)``, one span per phase:

- ``rbc_value`` / ``rbc_echo`` / ``rbc_ready`` — reliable-broadcast Value,
  Echo (incl. the EchoHash/CanDecode message-reduction variants), Ready;
- ``aba_bval`` / ``aba_aux`` / ``aba_conf`` / ``aba_coin`` / ``aba_term`` —
  binary agreement, one span **per ABA round** (the ``round`` field; Term
  is round-less);
- ``decrypt_share`` / ``decrypt_combine`` — threshold-decrypt share
  collection and the final interpolate+decode stretch (last share → batch);
- ``dkg_rotation`` — keyed per era: first signed Part/Ack observed → the
  batch that completes the change;
- ``epoch`` — the whole epoch, first phase activity → batch commit.

A span is ``[t_first, t_last]`` over the node's own monotonic clock plus a
message count; epochs are finalized when the driver reports a Step whose
output contains a committed batch.  Finished spans are retained bounded
(``max_spans``) and exportable as JSONL for offline analysis
(the JAX package's ``bench.py --net`` turns them into a per-phase p50/p99
breakdown); phase
durations also feed the ``hbbft_phase_duration_seconds`` histogram so a live
``/metrics`` scrape answers the same question without the JSONL.

This is exactly the phase-attribution instrument "The Latency Price of
Threshold Cryptosystems in Blockchains" builds ad hoc for its
measurements, kept always-on and per-node here.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Tuple

from hbbft_tpu_torch.obs.metrics import Registry
from hbbft_tpu_torch.traits import Step, StepObserver

NodeId = Hashable

#: canonical protocol order of phases inside one epoch (export sort key —
#: observed t_first is the real ordering; this breaks exact ties)
PHASE_ORDER = (
    "rbc_value", "rbc_echo", "rbc_ready",
    "aba_bval", "aba_aux", "aba_conf", "aba_coin", "aba_term",
    "decrypt_share", "decrypt_combine",
    "dkg_rotation", "epoch",
)


def phase_group(name: str) -> str:
    """Coarse bucket for reporting: rbc / aba / coin / decrypt / dkg /
    epoch — ``bench.py --net`` and ``obs.top`` aggregate at this level."""
    if name.startswith("rbc_"):
        return "rbc"
    if name == "aba_coin":
        return "coin"
    if name.startswith("aba_"):
        return "aba"
    if name.startswith("decrypt_"):
        return "decrypt"
    if name.startswith("dkg_"):
        return "dkg"
    return name


@dataclass(frozen=True)
class Span:
    """One finished phase span of one epoch on one node."""

    node: str
    name: str
    era: int
    epoch: int
    round: Optional[int]
    t_start: float
    t_end: float
    count: int

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def as_dict(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "name": self.name,
            "era": self.era,
            "epoch": self.epoch,
            "round": self.round,
            "t_start": round(self.t_start, 6),
            "t_end": round(self.t_end, 6),
            "duration_s": round(self.duration_s, 6),
            "count": self.count,
        }


class _Agg:
    __slots__ = ("t_first", "t_last", "count")

    def __init__(self, t: float):
        self.t_first = t
        self.t_last = t
        self.count = 0

    def hit(self, t: float) -> None:
        if t < self.t_first:
            self.t_first = t
        if t > self.t_last:
            self.t_last = t
        self.count += 1


class SpanTracer(StepObserver):
    """Per-node epoch-phase tracer (see module docstring)."""

    def __init__(self, registry: Optional[Registry] = None,
                 node: Any = None, clock=time.perf_counter,
                 max_spans: int = 8192, max_open_epochs: int = 64):
        self.registry = registry or Registry()
        self.node = repr(node) if node is not None else "?"
        self.clock = clock
        self.finished: "deque[Span]" = deque(maxlen=max_spans)
        # (era, epoch) → (phase name, round) → _Agg.  Bounded two ways:
        # a straggler message for an ALREADY-FINALIZED epoch must not
        # re-open it (it could never finalize again), and a Byzantine
        # peer minting arbitrary future (era, epoch) values must not
        # grow this dict without limit — beyond max_open_epochs the
        # lowest key is evicted (and counted), never silently
        self.max_open_epochs = max_open_epochs
        self._open: Dict[Tuple[int, int], Dict[Tuple[str, Optional[int]],
                                               _Agg]] = {}
        self._done: "deque[Tuple[int, int]]" = deque(maxlen=256)
        self._done_set: set = set()
        self._dkg_open: Dict[int, _Agg] = {}
        self.epochs_finalized = 0
        # optional per-span finalization hook: called with each Span the
        # moment it is finished (the flight recorder journals them here;
        # `finished` stays the bounded in-memory view)
        self.sink: Optional[Any] = None
        r = self.registry
        self._h_phase = r.histogram(
            "hbbft_phase_duration_seconds",
            "wall-clock span of each consensus phase per epoch",
            labelnames=("phase",), max_label_sets=len(PHASE_ORDER) + 1,
        )
        self._c_msgs = r.counter(
            "hbbft_phase_messages_total",
            "inbound consensus messages classified per phase",
            labelnames=("phase",), max_label_sets=len(PHASE_ORDER) + 1,
        )
        # per-phase child handles: labels() costs a tuple build + dict
        # lookup per call, and on_message runs once per consensus message
        # — caching the children was part of recovering the r01→r02
        # sequential-throughput regression
        self._msg_children: Dict[str, Any] = {}
        self._h_epoch = r.histogram(
            "hbbft_node_epoch_duration_seconds",
            "first phase activity to batch commit, per epoch",
        )
        self._c_epochs = r.counter(
            "hbbft_node_epochs_total", "batches committed"
        )
        self._c_evicted = r.counter(
            "hbbft_phase_open_epochs_evicted_total",
            "open epoch traces dropped unfinalized (straggler re-opens "
            "or Byzantine epoch-key floods past max_open_epochs)"
        )

    # -- StepObserver --------------------------------------------------------

    def on_message(self, sender_id: NodeId, message: Any,
                   t: Optional[float] = None) -> None:
        hit = classify(message)
        if hit is None:
            return
        era, epoch, phase, rnd = hit
        now = self.clock() if t is None else t
        child = self._msg_children.get(phase)
        if child is None:
            child = self._msg_children[phase] = self._c_msgs.labels(
                phase=phase)
        child.inc()
        if phase == "dkg_rotation":
            agg = self._dkg_open.get(era)
            if agg is None:
                if not self._admit(self._dkg_open, era, cap=8):
                    return
                agg = self._dkg_open[era] = _Agg(now)
            agg.hit(now)
            return
        key = (era, epoch)
        if key in self._done_set:
            return  # straggler for a finalized epoch: don't re-open
        per_epoch = self._open.get(key)
        if per_epoch is None:
            if not self._admit(self._open, key,
                               cap=self.max_open_epochs):
                return
            per_epoch = self._open[key] = {}
        agg = per_epoch.get((phase, rnd))
        if agg is None:
            agg = per_epoch[(phase, rnd)] = _Agg(now)
        agg.hit(now)

    def _admit(self, open_map: Dict, key, cap: int) -> bool:
        """Bounded insert: at the cap, the HIGHEST key — epochs/eras only
        grow, so the highest open key is the most speculative and the
        attacker-minted flood is all high future keys — loses: either the
        newcomer is rejected outright or the highest existing entry is
        evicted.  Either way the genuine in-progress (lowest) trace
        survives a Byzantine epoch-key flood, and state stays ≤ cap."""
        if len(open_map) < cap:
            return True
        self._c_evicted.inc()
        highest = max(open_map)
        if key >= highest:
            return False  # the newcomer is the most speculative: drop it
        del open_map[highest]
        return True

    def on_step(self, step: Step, t: Optional[float] = None) -> None:
        for out in step.output:
            key = _batch_key(out)
            if key is None:
                continue
            era, epoch, change_complete = key
            now = self.clock() if t is None else t
            self._finalize_epoch(era, epoch, now)
            if change_complete:
                self._finalize_dkg(era, epoch, now)

    # -- finalization --------------------------------------------------------

    def _finalize_epoch(self, era: int, epoch: int, now: float) -> None:
        per_epoch = self._open.pop((era, epoch), None)
        if per_epoch is None:
            per_epoch = {}
        key = (era, epoch)
        if key not in self._done_set:
            if len(self._done) == self._done.maxlen:
                self._done_set.discard(self._done[0])
            self._done.append(key)
            self._done_set.add(key)
        spans: List[Span] = []
        t0_epoch = min(
            (a.t_first for a in per_epoch.values()), default=now
        )
        last_share: Optional[float] = None
        for (phase, rnd), agg in per_epoch.items():
            spans.append(Span(self.node, phase, era, epoch, rnd,
                              agg.t_first, agg.t_last, agg.count))
            if phase == "decrypt_share":
                last_share = agg.t_last
        if last_share is not None:
            # the combine (interpolate + decode) has no messages of its
            # own: it is the stretch from the last share to the commit
            spans.append(Span(self.node, "decrypt_combine", era, epoch,
                              None, last_share, now, 0))
        spans.append(Span(self.node, "epoch", era, epoch, None,
                          t0_epoch, now, sum(s.count for s in spans)))
        spans.sort(key=lambda s: (s.t_start, PHASE_ORDER.index(s.name)
                                  if s.name in PHASE_ORDER else 99,
                                  s.round or 0))
        for s in spans:
            self.finished.append(s)
            if s.name == "epoch":
                self._h_epoch.observe(s.duration_s)
            else:
                self._h_phase.labels(phase=s.name).observe(s.duration_s)
            if self.sink is not None:
                self.sink(s)
        self.epochs_finalized += 1
        self._c_epochs.inc()

    def _finalize_dkg(self, era: int, epoch: int, now: float) -> None:
        agg = self._dkg_open.pop(era, None)
        t0 = agg.t_first if agg is not None else now
        count = agg.count if agg is not None else 0
        s = Span(self.node, "dkg_rotation", era, epoch, None, t0, now,
                 count)
        self.finished.append(s)
        self._h_phase.labels(phase="dkg_rotation").observe(s.duration_s)
        if self.sink is not None:
            self.sink(s)

    # -- export --------------------------------------------------------------

    def spans_for(self, era: int, epoch: int) -> List[Span]:
        # list() first: exports run on the obs event loop while the pump's
        # worker thread finalizes epochs into the deque
        return [s for s in list(self.finished)
                if s.era == era and s.epoch == epoch]

    def export_jsonl(self) -> str:
        """One JSON object per finished span, in finalization order."""
        finished = list(self.finished)
        return "\n".join(
            json.dumps(s.as_dict()) for s in finished
        ) + ("\n" if finished else "")


# -- message classification --------------------------------------------------

# The protocol message types classify() dispatches on, resolved ONCE on
# first use: obs must stay importable without dragging protocol modules in
# at module-import time (tools and tests import obs alone), but re-running
# a dozen import statements per message was the dominant per-message cost
# the r01→r02 obs regression traced to.
_T = None


class _ClassifyTypes:
    __slots__ = (
        "AlgoMessage", "KeyGenWrap", "HbWrap", "DecryptionShareWrap",
        "SubsetWrap", "BroadcastWrap", "AgreementWrap", "ValueMsg",
        "EchoLike", "ReadyMsg", "BValMsg", "AuxMsg", "ConfMsg", "CoinMsg",
        "TermMsg",
    )

    def __init__(self):
        from hbbft_tpu_torch.protocols.binary_agreement import (
            AuxMsg, BValMsg, CoinMsg, ConfMsg, TermMsg,
        )
        from hbbft_tpu_torch.protocols.broadcast import (
            CanDecodeMsg, EchoHashMsg, EchoMsg, ReadyMsg, ValueMsg,
        )
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
            HbWrap, KeyGenWrap,
        )
        from hbbft_tpu_torch.protocols.honey_badger import (
            DecryptionShareWrap, SubsetWrap,
        )
        from hbbft_tpu_torch.protocols.sender_queue import AlgoMessage
        from hbbft_tpu_torch.protocols.subset import AgreementWrap, BroadcastWrap

        self.AlgoMessage = AlgoMessage
        self.KeyGenWrap = KeyGenWrap
        self.HbWrap = HbWrap
        self.DecryptionShareWrap = DecryptionShareWrap
        self.SubsetWrap = SubsetWrap
        self.BroadcastWrap = BroadcastWrap
        self.AgreementWrap = AgreementWrap
        self.ValueMsg = ValueMsg
        self.EchoLike = (EchoMsg, EchoHashMsg, CanDecodeMsg)
        self.ReadyMsg = ReadyMsg
        self.BValMsg = BValMsg
        self.AuxMsg = AuxMsg
        self.ConfMsg = ConfMsg
        self.CoinMsg = CoinMsg
        self.TermMsg = TermMsg


_classify_memo: Tuple[Any, Any] = (None, None)


def classify(message: Any
             ) -> Optional[Tuple[int, int, str, Optional[int]]]:
    """``(era, epoch, phase, round)`` for a consensus message, walking the
    wrapper chain; ``None`` for control traffic (EpochStarted, heartbeats)
    that belongs to no epoch phase."""
    global _T, _classify_memo
    # every inbound message is classified twice on the hot path (span
    # tracer + flight-journal epoch attribution), back to back with the
    # SAME object: a one-entry identity memo halves the wrapper walks
    memo_key, memo_hit = _classify_memo
    if memo_key is message:
        return memo_hit
    hit = _classify_walk(message)
    _classify_memo = (message, hit)
    return hit


def _classify_walk(message: Any
                   ) -> Optional[Tuple[int, int, str, Optional[int]]]:
    global _T
    T = _T
    if T is None:
        T = _T = _ClassifyTypes()
    era = 0
    if isinstance(message, T.AlgoMessage):
        message = message.msg
    if isinstance(message, T.KeyGenWrap):
        return (message.era, 0, "dkg_rotation", None)
    if isinstance(message, T.HbWrap):
        era = message.era
        message = message.msg
    if isinstance(message, T.DecryptionShareWrap):
        return (era, message.epoch, "decrypt_share", None)
    if not isinstance(message, T.SubsetWrap):
        return None
    epoch = message.epoch
    inner = message.msg
    if isinstance(inner, T.BroadcastWrap):
        m = inner.msg
        if isinstance(m, T.ValueMsg):
            return (era, epoch, "rbc_value", None)
        if isinstance(m, T.EchoLike):
            return (era, epoch, "rbc_echo", None)
        if isinstance(m, T.ReadyMsg):
            return (era, epoch, "rbc_ready", None)
        return None
    if isinstance(inner, T.AgreementWrap):
        m = inner.msg
        if isinstance(m, T.BValMsg):
            return (era, epoch, "aba_bval", m.epoch)
        if isinstance(m, T.AuxMsg):
            return (era, epoch, "aba_aux", m.epoch)
        if isinstance(m, T.ConfMsg):
            return (era, epoch, "aba_conf", m.epoch)
        if isinstance(m, T.CoinMsg):
            return (era, epoch, "aba_coin", m.epoch)
        if isinstance(m, T.TermMsg):
            return (era, epoch, "aba_term", None)
        return None
    return None


def _batch_key(out: Any) -> Optional[Tuple[int, int, bool]]:
    """``(era, epoch, change_completed)`` when ``out`` is a committed
    batch of any flavor, else None."""
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DhbBatch
    from hbbft_tpu_torch.protocols.honey_badger import Batch as HbBatch
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QhbBatch
    from hbbft_tpu_torch.protocols.vid import VidQhbBatch

    if isinstance(out, (QhbBatch, DhbBatch, VidQhbBatch)):
        complete = getattr(out.change, "state", None) == "complete"
        return (out.era, out.epoch, complete)
    if isinstance(out, HbBatch):
        return (0, out.epoch, False)
    return None

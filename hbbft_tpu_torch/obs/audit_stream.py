"""Incremental audit core: streaming forensics over live flight journals.

The post-mortem auditor (:mod:`hbbft_tpu_torch.obs.audit`) historically read
every journal in full, then verified invariants in one batch pass.  This
module is the refactored **incremental core** the batch CLI is rebuilt
on: an :class:`IncrementalAuditor` accumulates exactly the state the
batch pass built — outbound payload index, equivocation slots, commit
chains, overload attribution, VID corroboration — one record at a time,
and :meth:`IncrementalAuditor.result` derives a full
:class:`~hbbft_tpu_torch.obs.audit.AuditResult` from that state at any moment.
Feeding a completed journal set record-for-record yields a verdict
**byte-identical** to the old batch pass (regression-tested in
``tests/test_obs_audit.py``), while a live consumer (the watchtower,
:mod:`hbbft_tpu_torch.obs.watch`) can call ``result()`` every poll tick and
see a fork or a conflicting (sender, slot) value seconds after the
evidence lands in a journal segment.

:class:`JournalTailer` is the disk side of streaming: it re-discovers
journal directories each poll, remembers a byte offset per segment file,
and parses only the appended suffix with the same framing validation as
:func:`hbbft_tpu_torch.obs.flight.read_segment_bytes` — a partial frame at the
tail of the *active* (newest) segment is simply retried next poll, and
only becomes a counted torn tail once the segment has rotated (or on
:meth:`JournalTailer.finalize`), mirroring the batch reader's
crash-tolerance.

State bounds: verdict-bearing state grows with the protocol (commit
chain length, distinct equivocation slots, offending peers), not with
wall-clock message volume — except the display timeline and the
send/receive matching index, which a live consumer caps via
``max_events`` (overflow is counted in ``events_dropped``, never
silent).
"""

from __future__ import annotations

import hashlib
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from hbbft_tpu_torch.fault_log import FaultKind, equivocation_kinds
from hbbft_tpu_torch.obs.flight import (
    _FRAME_HEADER,
    _SEGMENT_RE,
    _max_record_bytes,
    FlightCommit,
    FlightFault,
    FlightHello,
    FlightMsg,
    FlightNote,
    FlightSpan,
    find_journal_dirs,
    target_covers,
)
from hbbft_tpu_torch.obs.metrics import DEFAULT
from hbbft_tpu_torch.protocols import wire

#: timeline ordering rank per record family (notes lead their epoch,
#: then sends/receives, commits close it, spans/faults trail as derived)
_RANK = {"note": 0, "msg": 1, "commit": 2, "span": 3, "fault": 4}


#: FlightFault kinds that are protocol-layer overload evidence (flood
#: budgets engaging), as opposed to protocol misbehavior of other shapes
_OVERLOAD_FAULT_KINDS = frozenset({
    "FutureEpochFlood", "SubsetMessageFlood",
})


def _parse_guard_note(detail: str) -> Optional[Dict[str, str]]:
    """``kind=K peer=P …`` → {kind, peer[, claimed]} (the runtime's
    overload-guard journal format; see NodeRuntime._process_guard_event).
    ``auth_fail`` notes carry both sides of a spoof: ``peer`` is the
    ATTACKER's socket endpoint, ``claimed`` the impersonated identity —
    keeping them separate is what lets the incident report blame the
    endpoint without smearing the victim."""
    fields = dict(
        part.split("=", 1) for part in detail.split() if "=" in part
    )
    if "kind" not in fields or "peer" not in fields:
        return None
    out = {"kind": fields["kind"], "peer": fields["peer"]}
    if "claimed" in fields:
        out["claimed"] = fields["claimed"]
    return out


def _parse_statesync_note(detail: str) -> Optional[Dict[str, Any]]:
    """``index=N head=HEX`` → {index, head} (the boundary a snapshot
    joiner's runtime journals at activation)."""
    fields = dict(
        part.split("=", 1) for part in detail.split() if "=" in part
    )
    try:
        return {"index": int(fields["index"]), "head": fields["head"]}
    # hblint: disable=fault-swallowed-drop (accounted at the caller: a
    # None return lands in sync_mismatches and flips the verdict to fork)
    except (KeyError, ValueError):
        return None


def _parse_vid_note(detail: str) -> Optional[Dict[str, str]]:
    """``root=HEX … payload_sha3=D`` → field dict (the runtime's VID
    journal format: ``vid_cert`` notes from the proposer anchor the
    payload digest behind a dispersed root; ``vid_retrieved`` notes from
    every resolver must corroborate it)."""
    fields = dict(
        part.split("=", 1) for part in detail.split() if "=" in part
    )
    if "root" not in fields or "payload_sha3" not in fields:
        return None
    return fields


def _digest(payload: bytes) -> str:
    return hashlib.sha3_256(payload).hexdigest()[:16]


# ===========================================================================
# Equivocation slots
# ===========================================================================


def equivocation_key(msg: Any
                     ) -> Optional[Tuple[Tuple, bytes, FaultKind]]:
    """``(slot, value, FaultKind)`` for messages where one sender emitting
    two *different* values for the same slot is proof of equivocation;
    ``None`` for messages that may legitimately repeat with different
    values (BVal/Aux vote for both sides honestly, EpochStarted
    re-announces).  The slot includes everything that scopes the value;
    the sender is supplied by the caller."""
    from hbbft_tpu_torch.protocols.binary_agreement import (
        CoinMsg, ConfMsg, TermMsg,
    )
    from hbbft_tpu_torch.protocols.broadcast import (
        CanDecodeMsg, EchoHashMsg, EchoMsg, ReadyMsg, ValueMsg,
    )
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import HbWrap
    from hbbft_tpu_torch.protocols.honey_badger import (
        DecryptionShareWrap, SubsetWrap,
    )
    from hbbft_tpu_torch.protocols.sender_queue import AlgoMessage
    from hbbft_tpu_torch.protocols.subset import AgreementWrap, BroadcastWrap

    era = 0
    if isinstance(msg, AlgoMessage):
        msg = msg.msg
    if isinstance(msg, HbWrap):
        era = msg.era
        msg = msg.msg
    if isinstance(msg, DecryptionShareWrap):
        share = msg.msg.share
        return ((era, msg.epoch, "decrypt", repr(msg.proposer_id)),
                share.to_bytes(), FaultKind.MultipleDecryptionShares)
    if not isinstance(msg, SubsetWrap):
        return None
    epoch = msg.epoch
    inner = msg.msg
    if isinstance(inner, BroadcastWrap):
        proposer = repr(inner.proposer_id)
        m = inner.msg
        rules = (
            (ValueMsg, "value", FaultKind.MultipleValues),
            (EchoMsg, "echo", FaultKind.MultipleEchos),
            (EchoHashMsg, "echo_hash", FaultKind.MultipleEchoHashes),
            (CanDecodeMsg, "can_decode", FaultKind.MultipleCanDecodes),
            (ReadyMsg, "ready", FaultKind.MultipleReadys),
        )
        for cls, tag, kind in rules:
            if isinstance(m, cls):
                root = m.proof.root_hash if isinstance(
                    m, (ValueMsg, EchoMsg)) else m.root
                return ((era, epoch, "rbc", proposer, tag), root, kind)
        return None
    if isinstance(inner, AgreementWrap):
        proposer = repr(inner.proposer_id)
        m = inner.msg
        if isinstance(m, ConfMsg):
            value = bytes([(False in m.values)
                           | ((True in m.values) << 1)])
            return ((era, epoch, "aba", proposer, "conf", m.epoch),
                    value, FaultKind.MultipleConf)
        if isinstance(m, TermMsg):
            return ((era, epoch, "aba", proposer, "term"),
                    b"\x01" if m.value else b"\x00",
                    FaultKind.MultipleTerm)
        if isinstance(m, CoinMsg):
            inner_msg = m.msg
            share = getattr(inner_msg, "share", None)
            if share is not None:
                return ((era, epoch, "aba", proposer, "coin", m.epoch),
                        share.to_bytes(),
                        FaultKind.MultipleSignatureShares)
    return None


# ===========================================================================
# Result model
# ===========================================================================


@dataclass
class Event:
    """One timeline entry (sort-stable canonical key + display line)."""

    era: int
    epoch: int
    rank: int
    key: Tuple
    line: str


@dataclass
class AuditResult:
    nodes: List[str] = field(default_factory=list)
    events: List[Event] = field(default_factory=list)
    chains: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    first_divergence: Optional[Dict[str, Any]] = None
    self_conflicts: List[Dict[str, Any]] = field(default_factory=list)
    monotonicity_violations: List[Dict[str, Any]] = field(
        default_factory=list)
    equivocations: List[Dict[str, Any]] = field(default_factory=list)
    unmatched_receives: int = 0
    decode_failures: int = 0
    torn_tails: int = 0
    restarts: Dict[str, int] = field(default_factory=dict)
    status_mismatches: List[str] = field(default_factory=list)
    # membership lifecycle: nodes that activated from a state-sync
    # snapshot (the journal's ``statesync`` note declares the claimed
    # chain boundary), with the boundary verified against every other
    # journal's digest at the preceding index
    sync_joins: List[Dict[str, Any]] = field(default_factory=list)
    sync_mismatches: List[str] = field(default_factory=list)
    # conflicting slot values that attribute cleanly to DIFFERENT
    # incarnations of the sender (its own journal shows each value sent
    # exactly once, by a different process life): the expected amnesia
    # artifact of a crash-restart without persistence re-proposing into
    # already-decided epochs — reported, but not a fault verdict.  True
    # equivocation (two values inside one incarnation, or a value the
    # sender never journaled sending — the tampering shape) still is.
    restart_reproposals: List[Dict[str, Any]] = field(
        default_factory=list)
    # VID cert-vs-retrieval corroboration: every ``vid_retrieved`` note's
    # payload digest must agree with the proposer's ``vid_cert`` anchor
    # and with every other resolver of the same root.  Two digests behind
    # one committed root is a content fork — the ordered commitment was
    # unambiguous but nodes read different payloads through it.
    # Uncorroborated roots (proposer journal rotated, no retrieval yet)
    # are benign and merely counted.
    vid_roots: int = 0
    vid_corroborated: int = 0
    vid_inconsistencies: List[Dict[str, Any]] = field(
        default_factory=list)
    # resource-exhaustion forensics: journaled ``guard`` notes (ingress
    # throttle escalations, SenderQueue backlog evictions, hello rejects
    # — written by the runtime's overload defense) plus protocol-layer
    # flood faults (FutureEpochFlood / SubsetMessageFlood), aggregated
    # per OFFENDING peer so an incident attributes to the spamming node.
    # Defense working as designed is not a fault verdict.
    overload_incidents: List[Dict[str, Any]] = field(default_factory=list)
    # timeline entries a bounded live consumer dropped past its
    # ``max_events`` cap (always 0 in the unbounded batch audit)
    events_dropped: int = 0

    @property
    def first_affected_epoch(self) -> Optional[Tuple[int, int]]:
        keys = [(e["era"], e["epoch"]) for e in self.equivocations]
        return min(keys) if keys else None

    @property
    def verdict(self) -> str:
        if self.first_divergence or self.self_conflicts \
                or self.status_mismatches or self.sync_mismatches \
                or self.vid_inconsistencies:
            return "fork"
        if self.equivocations or self.monotonicity_violations:
            return "fault"
        return "clean"

    def as_dict(self) -> Dict[str, Any]:
        fa = self.first_affected_epoch
        return {
            "verdict": self.verdict,
            "nodes": self.nodes,
            "restarts": self.restarts,
            "torn_tails": self.torn_tails,
            "decode_failures": self.decode_failures,
            "unmatched_receives": self.unmatched_receives,
            "chains": {
                n: {"head": c["head"], "len": c["len"]}
                for n, c in self.chains.items()
            },
            "first_divergence": self.first_divergence,
            "self_conflicts": self.self_conflicts,
            "monotonicity_violations": self.monotonicity_violations,
            "equivocations": self.equivocations,
            "first_affected_epoch": list(fa) if fa else None,
            "status_mismatches": self.status_mismatches,
            "sync_joins": self.sync_joins,
            "sync_mismatches": self.sync_mismatches,
            "restart_reproposals": self.restart_reproposals,
            "overload_incidents": self.overload_incidents,
            "vid_roots": self.vid_roots,
            "vid_corroborated": self.vid_corroborated,
            "vid_inconsistencies": self.vid_inconsistencies,
        }


def _is_restart_reproposal(vals: Dict[str, Any],
                           sent: Optional[Dict[str, set]]) -> bool:
    """Do the conflicting values attribute cleanly to different process
    incarnations of the sender?  Requires the sender's own journal to
    show EVERY witnessed value being sent, each by exactly one
    incarnation, all incarnations distinct — the amnesia shape of a
    crash-restart re-proposing into already-decided epochs.  Anything
    less (a value the sender never journaled — tampering; two values in
    one incarnation — equivocation; rotated-away sender evidence) stays
    slashing-grade."""
    if sent is None:
        return False
    if set(vals) - set(sent):
        return False
    incs = [sent[d] for d in vals]
    if any(len(s) != 1 for s in incs):
        return False
    flat = [next(iter(s)) for s in incs]
    return len(set(flat)) == len(flat)


# ===========================================================================
# Incremental core
# ===========================================================================


class IncrementalAuditor:
    """Record-at-a-time accumulation of the audit state.

    ``feed(node, incarnation, record)`` applies one journal record;
    ``result()`` derives a complete :class:`AuditResult` from whatever
    has been fed so far and may be called repeatedly (every watchtower
    poll tick).  The derivation re-runs only the cross-record sections
    (timeline sort, overload attribution order, VID corroboration,
    digest-chain divergence scan, sync-join verification, equivocation
    vs restart-re-proposal classification) — all accumulation is
    single-pass at feed time.

    Send/receive matching is deferred to ``result()`` because a tailer
    may surface a receive before the matching send's journal bytes: the
    batch pass indexed every outbound payload before walking any
    receive, and deferring the check reproduces that order-independence
    exactly.

    ``max_events`` bounds the display timeline (the only state that
    grows per message rather than per protocol object a live consumer
    cares about); overflow is counted in ``events_dropped``.
    """

    def __init__(self, max_events: Optional[int] = None):
        self.max_events = max_events
        self._nodes: List[str] = []            # first-seen journal order
        self._incs: Dict[str, List[int]] = {}  # node → incarnations seen
        self.torn_tails = 0
        self.decode_failures = 0
        self.events_dropped = 0
        self._events: List[Event] = []
        # sender node → payload digest → [(incarnation, FlightMsg)]
        self._out_index: Dict[
            str, Dict[str, List[Tuple[int, FlightMsg]]]] = {}
        # deferred receive matching: (sender, digest, receiver) → count
        self._recv_pending: Dict[Tuple[str, str, str], int] = {}
        # slots[(sender, slot, kind)] = {value_digest: set(witnesses)}
        self._slots: Dict[Tuple, Dict[str, set]] = {}
        # the sender's own account: per slot, which incarnation(s)
        # journaled SENDING each value — what separates a crash-restart
        # re-proposal from equivocation/tampering
        self._slot_sends: Dict[Tuple, Dict[str, set]] = {}
        self._commits: Dict[str, Dict[int, Tuple[str, int, int, int]]] = {}
        self._last_key: Dict[Tuple[str, int], Tuple[int, int]] = {}
        # overload[peer] = {"kinds": {...}, "witnesses": set, "claimed": set}
        self._overload: Dict[str, Dict[str, Any]] = {}
        # vid[root] = {payload_sha3: {"cert:<node>" | "retr:<node>", ...}}
        self._vid: Dict[str, Dict[str, set]] = {}
        self._vid_anchored: set = set()
        # feed-time findings, copied into each result()
        self._self_conflicts: List[Dict[str, Any]] = []
        self._monotonicity: List[Dict[str, Any]] = []
        self._sync_joins: List[Dict[str, Any]] = []
        self._sync_malformed: List[str] = []
        self._vid_malformed: List[Dict[str, Any]] = []
        self.records_fed = 0

    # -- registration --------------------------------------------------------

    def add_node(self, node: str) -> None:
        """Declare a journal's node (first-seen order fixes the report's
        node order, matching the batch pass's journal order)."""
        if node not in self._incs:
            self._incs[node] = []
            self._nodes.append(node)

    def observe_incarnation(self, node: str, inc: int) -> None:
        self.add_node(node)
        incs = self._incs[node]
        if inc not in incs:
            incs.append(inc)

    def add_torn(self, n: int = 1) -> None:
        self.torn_tails += n

    def _event(self, ev: Event) -> None:
        if self.max_events is not None \
                and len(self._events) >= self.max_events:
            self.events_dropped += 1
            return
        self._events.append(ev)

    # -- per-record accumulation ---------------------------------------------

    def feed(self, node: str, inc: int, rec: Any) -> None:
        """Apply one journal record (tagged with the process incarnation
        that wrote it) to the audit state."""
        self.observe_incarnation(node, inc)
        self.records_fed += 1
        if isinstance(rec, FlightMsg):
            self._feed_msg(node, inc, rec)
        elif isinstance(rec, FlightCommit):
            self._feed_commit(node, inc, rec)
        elif isinstance(rec, FlightFault):
            self._event(Event(
                rec.era, rec.epoch, _RANK["fault"],
                ("fault", rec.kind, rec.node, node, inc, rec.seq),
                f"era={rec.era} ep={rec.epoch} fault {rec.kind} "
                f"by {rec.node} seen@{node}#{inc}"))
            if rec.kind in _OVERLOAD_FAULT_KINDS:
                self._overload_hit(rec.node, rec.kind, node)
        elif isinstance(rec, FlightSpan):
            rnd = "-" if rec.round is None else rec.round
            self._event(Event(
                rec.era, rec.epoch, _RANK["span"],
                ("span", rec.name, rnd, node, inc, rec.seq),
                f"era={rec.era} ep={rec.epoch} span {rec.name} "
                f"r={rnd} n={rec.count} @{node}#{inc}"))
        elif isinstance(rec, FlightNote):
            self._feed_note(node, inc, rec)
        # FlightHello / FlightTrace carry no audit invariants

    def _feed_msg(self, node: str, inc: int, rec: FlightMsg) -> None:
        d = _digest(rec.payload) if rec.payload else "-"
        if rec.direction == "in":
            line = (f"era={rec.era} ep={rec.epoch} msg "
                    f"{rec.mtype} {d} {rec.peer}->{node} "
                    f"in@{node}#{inc}.{rec.seq}")
        else:
            line = (f"era={rec.era} ep={rec.epoch} msg "
                    f"{rec.mtype} {d} {node}->({rec.peer}) "
                    f"out@{node}#{inc}.{rec.seq}")
        self._event(Event(
            rec.era, rec.epoch, _RANK["msg"],
            (rec.mtype, d, 0 if rec.direction == "out" else 1,
             node, inc, rec.seq), line))
        if rec.direction == "out" and rec.payload:
            self._out_index.setdefault(node, {}).setdefault(
                d, []).append((inc, rec))
            # the sender's own account of what it emitted for each
            # equivocation slot, tagged with the process incarnation
            # that sent it
            try:
                msg = wire.decode_message(rec.payload)
            except (ValueError, TypeError):
                self.decode_failures += 1
                return
            eq = equivocation_key(msg)
            if eq is not None:
                slot, value, kind = eq
                self._slot_sends.setdefault(
                    (node, slot, kind), {}).setdefault(
                    _digest(value), set()).add(inc)
        if rec.direction != "in" or not rec.payload:
            return
        # receive↔send matching is resolved at result() time, once the
        # sender's outbound index is as complete as it is going to get
        key = (rec.peer, d, node)
        self._recv_pending[key] = self._recv_pending.get(key, 0) + 1
        # equivocation slots are receiver-side evidence
        try:
            msg = wire.decode_message(rec.payload)
        except (ValueError, TypeError):
            self.decode_failures += 1
            return
        eq = equivocation_key(msg)
        if eq is not None:
            slot, value, kind = eq
            vals = self._slots.setdefault((rec.peer, slot, kind), {})
            vals.setdefault(_digest(value), set()).add(node)

    def _feed_commit(self, node: str, inc: int, rec: FlightCommit) -> None:
        per_index = self._commits.setdefault(node, {})
        dig = rec.digest.hex()
        self._event(Event(
            rec.era, rec.epoch, _RANK["commit"],
            ("commit", rec.index, node, inc, rec.seq),
            f"era={rec.era} ep={rec.epoch} commit "
            f"idx={rec.index} {dig[:16]} @{node}#{inc}"))
        prev = per_index.get(rec.index)
        if prev is not None and prev[0] != dig:
            self._self_conflicts.append({
                "node": node, "index": rec.index,
                "digests": sorted((prev[0][:16], dig[:16])),
            })
        else:
            per_index[rec.index] = (dig, rec.era, rec.epoch, inc)
        last = self._last_key.get((node, inc))
        if last is not None and (rec.era, rec.epoch) <= last:
            self._monotonicity.append({
                "node": node, "incarnation": inc,
                "prev": list(last),
                "next": [rec.era, rec.epoch],
            })
        self._last_key[(node, inc)] = (rec.era, rec.epoch)

    def _feed_note(self, node: str, inc: int, rec: FlightNote) -> None:
        self._event(Event(
            0, 0, _RANK["note"],
            ("note", rec.kind, node, inc, rec.seq),
            f"note {rec.kind} {rec.detail} @{node}#{inc}"))
        if rec.kind == "statesync":
            join = _parse_statesync_note(rec.detail)
            if join is None:
                self._sync_malformed.append(
                    f"{node}#{inc}: malformed statesync note "
                    f"{rec.detail!r}")
            else:
                join.update({"node": node, "incarnation": inc})
                self._sync_joins.append(join)
        elif rec.kind == "guard":
            hit = _parse_guard_note(rec.detail)
            if hit is not None:
                self._overload_hit(hit["peer"], hit["kind"], node,
                                   hit.get("claimed"))
        elif rec.kind in ("vid_cert", "vid_retrieved"):
            fields = _parse_vid_note(rec.detail)
            if fields is None:
                self._vid_malformed.append({
                    "root": "?",
                    "error": f"malformed {rec.kind} note "
                             f"{rec.detail!r} @{node}#{inc}",
                })
                return
            sha3 = fields["payload_sha3"]
            if sha3 == "none":
                # failed retrieval — already surfaced through the
                # vid_mismatch/vid_exhausted notes and the proposer
                # fault; no digest to corroborate
                return
            tag = "cert" if rec.kind == "vid_cert" else "retr"
            self._vid.setdefault(fields["root"], {}).setdefault(
                sha3, set()).add(f"{tag}:{node}")
            if rec.kind == "vid_cert":
                self._vid_anchored.add(fields["root"])

    def _overload_hit(self, peer: str, kind: str, witness: str,
                      claimed: Optional[str] = None) -> None:
        entry = self._overload.setdefault(
            peer, {"kinds": {}, "witnesses": set(), "claimed": set()})
        entry["kinds"][kind] = entry["kinds"].get(kind, 0) + 1
        entry["witnesses"].add(witness)
        if claimed is not None:
            entry["claimed"].add(claimed)

    # -- derivation ----------------------------------------------------------

    def result(self) -> AuditResult:
        """Derive a full :class:`AuditResult` from the state fed so far.

        Safe to call repeatedly; the accumulated state is never mutated
        by the derivation (sync-join entries are copied before the
        boundary verdict is stamped on them)."""
        res = AuditResult()
        res.nodes = list(self._nodes)
        res.restarts = {n: max(0, len(self._incs[n]) - 1)
                        for n in self._nodes}
        res.torn_tails = self.torn_tails
        res.decode_failures = self.decode_failures
        res.events_dropped = self.events_dropped
        res.events = sorted(
            self._events, key=lambda e: (e.era, e.epoch, e.rank, e.key))
        res.self_conflicts = list(self._self_conflicts)
        res.monotonicity_violations = list(self._monotonicity)
        res.sync_joins = [dict(j) for j in self._sync_joins]
        res.sync_mismatches = list(self._sync_malformed)
        res.vid_inconsistencies = list(self._vid_malformed)

        # deferred send↔receive matching against the now-complete index
        for (sender, d, node), count in self._recv_pending.items():
            if sender not in self._incs:
                continue  # no journal for the sender — nothing to match
            outs = self._out_index.get(sender, {}).get(d, ())
            if not any(target_covers(o.peer, node) for _i, o in outs):
                res.unmatched_receives += count

        # resource-exhaustion attribution: most-implicated peer first
        res.overload_incidents = [
            {
                "peer": peer,
                "kinds": dict(sorted(entry["kinds"].items())),
                "witnesses": sorted(entry["witnesses"]),
                "events": sum(entry["kinds"].values()),
                # spoof attribution: the identities this endpoint
                # CLAIMED while failing authentication (distinct from
                # "peer" — the impersonated validator is the victim,
                # not the attacker)
                **({"claimed_identities": sorted(entry["claimed"])}
                   if entry["claimed"] else {}),
            }
            for peer, entry in sorted(
                self._overload.items(),
                key=lambda kv: (-sum(kv[1]["kinds"].values()), kv[0]),
            )
        ]

        # -- VID cert-vs-retrieval consistency -------------------------------
        # One root, one payload: the proposer's vid_cert digest and
        # every resolver's vid_retrieved digest must be THE same sha3.
        # A root only counts as corroborated when at least two
        # independent accounts agree (cert + a retrieval, or two
        # retrievals); a lone account is benign but proves nothing.
        res.vid_roots = len(self._vid)
        for root in sorted(self._vid):
            digests = self._vid[root]
            if len(digests) > 1:
                res.vid_inconsistencies.append({
                    "root": root,
                    "anchored": root in self._vid_anchored,
                    "digests": {d: sorted(w)
                                for d, w in sorted(digests.items())},
                })
            elif sum(len(w) for w in digests.values()) >= 2:
                res.vid_corroborated += 1

        # -- digest-chain agreement ------------------------------------------
        for node, per_index in self._commits.items():
            if per_index:
                top = max(per_index)
                res.chains[node] = {
                    "len": top + 1,
                    "head": per_index[top][0],
                    "commits": per_index,
                }
        all_indices = sorted(
            {i for c in self._commits.values() for i in c})
        for i in all_indices:
            present = {n: c[i]
                       for n, c in self._commits.items() if i in c}
            if len({v[0] for v in present.values()}) > 1:
                res.first_divergence = {
                    "index": i,
                    "per_node": {
                        n: {"digest": v[0][:16], "era": v[1],
                            "epoch": v[2]}
                        for n, v in sorted(present.items())
                    },
                    "era": min(v[1] for v in present.values()),
                    "epoch": min(v[2] for v in present.values()),
                }
                break

        # -- membership-lifecycle boundaries ---------------------------------
        # A state-sync join claims "my chain starts at index k with
        # head H".  That claim must match what the rest of the cluster
        # committed: any journal holding index k−1 must hold digest H
        # there.  A joiner whose claimed boundary nobody can
        # corroborate stays unverified (benign: donors' journals may
        # have rotated past it); a CONTRADICTED boundary is a fork.
        for join in res.sync_joins:
            idx, head = join["index"], join["head"]
            verified = None
            for other, per_index in self._commits.items():
                prev = per_index.get(idx - 1)
                if prev is None:
                    continue
                if prev[0] == head:
                    verified = other
                else:
                    res.sync_mismatches.append(
                        f"{join['node']} joined claiming "
                        f"chain[{idx - 1}] = {head[:16]} but {other} "
                        f"committed {prev[0][:16]} there")
                    verified = None
                    break
            join["verified_against"] = verified

        # -- equivocation evidence -------------------------------------------
        eq_kinds = equivocation_kinds()
        for (sender, slot, kind), vals in sorted(
                self._slots.items(), key=lambda kv: repr(kv[0])):
            if len(vals) < 2:
                continue
            assert kind in eq_kinds
            entry = {
                "sender": sender,
                "kind": kind.name,
                "era": slot[0],
                "epoch": slot[1],
                "slot": repr(slot),
                "values": {d: sorted(w)
                           for d, w in sorted(vals.items())},
            }
            if _is_restart_reproposal(vals, self._slot_sends.get(
                    (sender, slot, kind))):
                res.restart_reproposals.append(entry)
            else:
                res.equivocations.append(entry)
        return res


# ===========================================================================
# Journal tailing
# ===========================================================================

_c_stream_torn = DEFAULT.counter(
    "hbbft_obs_stream_torn_tails_total",
    "rotated/finalized journal segments the streaming auditor found "
    "torn mid-record (skipped loudly, like the batch reader)")
_c_stream_records = DEFAULT.counter(
    "hbbft_obs_stream_records_total",
    "journal records consumed by the streaming auditor's tailer")
_c_stream_read_fail = DEFAULT.counter(
    "hbbft_obs_stream_read_failures_total",
    "journal segment reads the tailer could not complete (I/O error); "
    "retried on the next poll")


@dataclass
class _SegmentCursor:
    """Per-segment tail state: how many bytes have been consumed, and
    whether the segment is finished (fully parsed or counted torn)."""

    offset: int = 0
    done: bool = False
    hello_seen: bool = False


class _DirTail:
    """Incremental reader of ONE node's journal directory."""

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self.node: Optional[str] = None
        self.cursors: Dict[str, _SegmentCursor] = {}

    def segments(self) -> List[Tuple[int, int, str]]:
        try:
            names = os.listdir(self.dirpath)
        except OSError:
            _c_stream_read_fail.inc()
            return []
        out = [(int(m.group(1)), int(m.group(2)), name)
               for name in names
               for m in (_SEGMENT_RE.match(name),) if m]
        return sorted(out)


class JournalTailer:
    """Feed an :class:`IncrementalAuditor` from journals as they grow.

    Each :meth:`poll` re-discovers journal directories under ``roots``
    (new nodes appear as their first segment lands), reads only the
    bytes appended to each segment since the previous poll, and feeds
    every complete, CRC-valid record to the auditor.  Framing validation
    matches :func:`hbbft_tpu_torch.obs.flight.read_segment_bytes`:

    - an **incomplete** frame (header or payload cut) at the tail of the
      newest segment is a write in progress — the cursor holds and the
      poll retries it later; once a newer segment exists (rotation) or
      :meth:`finalize` runs, the leftover is a counted torn tail;
    - **corrupt** framing (absurd length, CRC mismatch, undecodable
      payload) is immediately a torn tail: the segment is closed and its
      remaining bytes skipped, exactly like the batch reader.

    Records are attributed to the incarnation in the segment filename
    (the batch reader's rule), and the node name comes from the
    segment-leading :class:`~hbbft_tpu_torch.obs.flight.FlightHello`.
    """

    def __init__(self, roots: List[str],
                 auditor: Optional[IncrementalAuditor] = None,
                 max_read_bytes: int = 32 * 2**20):
        self.roots = list(roots)
        self.auditor = auditor if auditor is not None \
            else IncrementalAuditor()
        # one segment read is bounded per poll; a backlogged journal is
        # drained across successive polls instead of one giant read
        self.max_read_bytes = max_read_bytes
        self._dirs: Dict[str, _DirTail] = {}

    # -- discovery -----------------------------------------------------------

    def _discover(self) -> None:
        for root in self.roots:
            for d in find_journal_dirs(root):
                if d not in self._dirs:
                    self._dirs[d] = _DirTail(d)

    # -- polling -------------------------------------------------------------

    def poll(self, final: bool = False) -> int:
        """Consume newly-appended journal bytes; returns records fed.

        ``final=True`` treats every segment as rotated: a leftover
        partial frame becomes a counted torn tail instead of being
        retried (use once the run being audited has stopped)."""
        self._discover()
        fed = 0
        for d in sorted(self._dirs):
            fed += self._poll_dir(self._dirs[d], final)
        return fed

    def finalize(self) -> int:
        """One last poll with every partial tail treated as torn."""
        return self.poll(final=True)

    def result(self) -> AuditResult:
        return self.auditor.result()

    def _poll_dir(self, tail: _DirTail, final: bool) -> int:
        segs = tail.segments()
        fed = 0
        for pos, (inc, _idx, name) in enumerate(segs):
            cur = tail.cursors.setdefault(name, _SegmentCursor())
            if cur.done:
                continue
            # the newest segment may still be mid-write; anything older
            # has rotated and must parse completely or count as torn
            active = (pos == len(segs) - 1) and not final
            fed += self._consume(tail, inc, name, cur, active)
        return fed

    def _consume(self, tail: _DirTail, inc: int, name: str,
                 cur: _SegmentCursor, active: bool) -> int:
        path = os.path.join(tail.dirpath, name)
        try:
            with open(path, "rb") as fh:
                fh.seek(cur.offset)
                data = fh.read(self.max_read_bytes)
                # did the bounded read reach EOF?  only an EOF'd
                # inactive segment may be declared done/torn below
                at_eof = not data or fh.read(1) == b""
        except OSError:
            # a vanished segment (checkpoint truncation / max_segments
            # cap racing the tailer) is retired, not retried forever
            _c_stream_read_fail.inc()
            if not os.path.exists(path):
                cur.done = True
            return 0
        fed = 0
        pos = 0
        n = len(data)
        max_record = _max_record_bytes()
        torn = False
        while pos < n:
            if pos + _FRAME_HEADER.size > n:
                break  # incomplete header (mid-write or torn)
            length, crc = _FRAME_HEADER.unpack_from(data, pos)
            if length > max_record:
                torn = True  # corrupt: absurd length can never complete
                break
            if pos + 8 + length > n:
                break  # incomplete payload (mid-write or torn)
            payload = data[pos + 8: pos + 8 + length]
            if zlib.crc32(payload) != crc:
                torn = True  # corrupt: bit rot / partial overwrite
                break
            try:
                rec = wire.decode_message(
                    payload, max_bytes=max_record,
                    max_blob=len(payload))
            # hblint: disable=fault-swallowed-drop (accounted below:
            # the torn branch counts hbbft_obs_stream_torn_tails_total
            # and the auditor's torn_tails, same as the batch reader)
            except (ValueError, TypeError):
                torn = True  # corrupt: framing intact, payload not
                break
            pos += 8 + length
            fed += 1
            _c_stream_records.inc()
            if isinstance(rec, FlightHello):
                tail.node = rec.node
                self.auditor.observe_incarnation(rec.node, inc)
                cur.hello_seen = True
            elif tail.node is not None:
                self.auditor.feed(tail.node, inc, rec)
            else:
                # no hello yet for this journal (damaged first segment):
                # attribute to the directory name, the only identity left
                self.auditor.feed(os.path.basename(tail.dirpath), inc,
                                  rec)
        cur.offset += pos
        leftover = pos < n or not at_eof
        if torn or (leftover and not active and at_eof):
            # corrupt now, or an incomplete tail on a segment that can
            # no longer grow: skip the rest loudly, once
            cur.done = True
            self.auditor.add_torn()
            _c_stream_torn.inc()
        elif not leftover and not active:
            cur.done = True  # rotated segment fully consumed
        return fed


# ===========================================================================
# Structured incidents (the watchtower's view of an AuditResult)
# ===========================================================================


def extract_incidents(res: AuditResult) -> List[Dict[str, Any]]:
    """Flatten an :class:`AuditResult` into structured incident dicts.

    Each incident carries a stable ``key`` — identical evidence yields
    the identical key on every poll tick, which is what lets a live
    consumer (the watchtower) deduplicate across ticks and raise exactly
    ONE incident per underlying fault.  ``severity`` mirrors the verdict
    contribution: ``fork`` entries flip the verdict to fork, ``fault``
    to fault, ``info`` entries never change a clean verdict.
    """
    out: List[Dict[str, Any]] = []

    def add(kind: str, severity: str, subject: str, key: str,
            detail: str) -> None:
        out.append({"kind": kind, "severity": severity,
                    "subject": subject, "key": key, "detail": detail})

    if res.first_divergence:
        d = res.first_divergence
        add("fork", "fork", "cluster",
            f"fork:index={d['index']}",
            f"first divergent epoch era={d['era']} epoch={d['epoch']} "
            f"(chain index {d['index']})")
    for c in res.self_conflicts:
        add("self_fork", "fork", c["node"],
            f"self_fork:{c['node']}:index={c['index']}",
            f"{c['node']} rebuilt index {c['index']} differently: "
            f"{c['digests']}")
    for m in res.sync_mismatches:
        add("sync_mismatch", "fork", m.split(":", 1)[0].split(" ", 1)[0],
            f"sync_mismatch:{m}", m)
    for v in res.vid_inconsistencies:
        if "error" in v:
            add("vid_mismatch", "fork", "?",
                f"vid_malformed:{v['error']}", v["error"])
        else:
            add("vid_mismatch", "fork", v["root"],
                f"vid_mismatch:root={v['root']}",
                f"nodes read different payloads through committed "
                f"root {v['root'][:24]}")
    for m in res.status_mismatches:
        add("status_mismatch", "fork", m.split(":", 1)[0],
            f"status_mismatch:{m}", m)
    for e in res.equivocations:
        add("equivocation", "fault", e["sender"],
            f"equivocation:{e['sender']}:{e['kind']}:{e['slot']}",
            f"{e['sender']} {e['kind']} era={e['era']} "
            f"epoch={e['epoch']} slot={e['slot']}")
    for v in res.monotonicity_violations:
        add("monotonicity", "fault", v["node"],
            f"monotonicity:{v['node']}#{v['incarnation']}:"
            f"{v['prev']}->{v['next']}",
            f"{v['node']}#{v['incarnation']} committed {v['next']} "
            f"after {v['prev']}")
    for o in res.overload_incidents:
        kinds = " ".join(f"{k}×{n}" for k, n in o["kinds"].items())
        add("overload", "info", o["peer"],
            f"overload:{o['peer']}:{':'.join(sorted(o['kinds']))}",
            f"peer {o['peer']} — {kinds} (witnessed by "
            f"{', '.join(o['witnesses'])})")
    for e in res.restart_reproposals:
        add("restart_reproposal", "info", e["sender"],
            f"restart_reproposal:{e['sender']}:{e['kind']}:{e['slot']}",
            f"{e['sender']} {e['kind']} era={e['era']} "
            f"epoch={e['epoch']} — each value sent by a different "
            f"incarnation")
    return out

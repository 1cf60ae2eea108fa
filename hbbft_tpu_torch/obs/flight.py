"""Black-box flight recorder: a bounded on-disk journal of protocol events.

Every node (real-socket ``NodeRuntime`` or deterministic ``VirtualNet``
sim) can append one record per protocol event to a per-node **journal**:
inbound/outbound consensus messages (with sender/target, (era, epoch) and
the full wire payload), batch commits carrying the ledger-digest chain
head, every ``FaultLog`` entry, span finalizations from
:class:`~hbbft_tpu_torch.obs.spans.SpanTracer`, and lifecycle notes (start /
restart / replay-gap / crash / stop).  The journal is what the forensic
auditor (the JAX package's ``obs/audit.py``, not ported yet) merges
across nodes to reconstruct *what happened, in what order, on whom* after
a fork, stall, or slashing
— the offline sibling of the live ``/metrics`` endpoint, in the spirit of
Thetacrypt's per-node event records.

On-disk format (byte-deterministic given a deterministic run):

- a journal is a directory of **segment files** ``seg-IIII-NNNNNN.fjl``
  (``IIII`` = incarnation, bumped every process (re)start; ``NNNNNN`` =
  rotation index).  Segments rotate at ``max_segment_bytes`` and the
  oldest are deleted beyond ``max_segments`` — the recorder is bounded;
- each segment is a sequence of framed records:
  ``u32 length | u32 crc32(payload) | payload`` where ``payload`` is the
  :func:`hbbft_tpu_torch.protocols.wire.encode_message` bytes of one of the
  ``Flight*`` record dataclasses below — journal records are registered
  with the wire codec like any other protocol message, so the
  wire-completeness checker and the per-type hash/round-trip regression
  cover the durable format;
- every segment begins with a :class:`FlightHello` so any single file
  self-describes its node/flavor/incarnation;
- a torn tail (mid-record truncation after a crash) is skipped loudly:
  the reader stops the segment, counts
  ``hbbft_obs_flight_torn_tails_total``, and never raises.

The recorder's own failure paths are accounted, never silent: a disk
error counts ``hbbft_obs_flight_write_failures_total`` (no
failure is dropped silently), an unencodable message
counts ``hbbft_obs_flight_encode_skips_total``.

Timestamps: ``clock=None`` (the ``VirtualNet`` default) stamps records
with a **logical clock** — the record sequence number — so two runs of
the same deterministic schedule produce byte-identical journals; the
networked runtime passes a real clock for cross-node forensics.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import struct
import zlib
from collections import deque
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.obs.metrics import DEFAULT, Registry
from hbbft_tpu_torch.obs.trace import (
    STAGE_HOPS, FlightTrace, iter_tids, pack_tids, trace_id,
)
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.traits import Step, StepObserver

logger = logging.getLogger("hbbft_tpu_torch.obs")

#: (era, epoch) recorded for control traffic that belongs to no epoch
#: (heartbeat-adjacent runtime messages, unclassifiable payloads) —
#: sorts after every real epoch in the audit timeline
UNKNOWN_EPOCH = (1 << 64) - 1

_SEGMENT_RE = re.compile(r"^seg-(\d{4})-(\d{6})\.fjl$")
_FRAME_HEADER = struct.Struct(">II")


def _max_record_bytes() -> int:
    """Reader-side sanity cap on a single record's claimed length —
    larger claims are treated as corruption (torn tail), not allocated.
    Resolved at call time because the wire caps are documented as
    deployment-raisable module knobs; a journal written under a raised
    cap must read back under the same setting."""
    return wire.MAX_MESSAGE_BYTES + 4096


# ===========================================================================
# Journal record types (wire-registered — see wire._lazy_register 0x80-0x85)
# ===========================================================================


@dataclass(frozen=True)
class FlightHello:
    """Segment header: which node wrote this journal, and its lifecycle
    incarnation (bumped per process start — restarts are visible)."""

    node: str
    flavor: str          # "runtime" (sockets) | "virtualnet" (sim)
    incarnation: int
    seq: int
    t: float


@dataclass(frozen=True)
class FlightMsg:
    """One consensus message crossing this node's boundary."""

    seq: int
    t: float
    direction: str       # "in" | "out"
    peer: str            # in: repr(sender); out: target descriptor
    era: int
    epoch: int
    mtype: str           # message class name
    payload: bytes       # wire.encode_message bytes (b"" if unencodable)


@dataclass(frozen=True)
class FlightCommit:
    """A committed batch: the ledger-digest chain head after folding it."""

    seq: int
    t: float
    era: int
    epoch: int
    index: int           # position in the digest chain (0-based)
    digest: bytes        # chain head after this batch (32 bytes)


@dataclass(frozen=True)
class FlightFault:
    """One FaultLog entry: ``node`` did ``kind`` (FaultKind name).

    ``(era, epoch)`` is the key of the inbound message being handled
    when the fault was logged (:data:`UNKNOWN_EPOCH` for faults raised
    outside message handling, e.g. on local input) — it places the
    evidence inside its epoch on the audit timeline."""

    seq: int
    t: float
    node: str
    kind: str
    era: int
    epoch: int


@dataclass(frozen=True)
class FlightSpan:
    """A finalized epoch-phase span (see obs.spans.Span)."""

    seq: int
    t: float
    name: str
    era: int
    epoch: int
    round: Optional[int]
    t_start: float
    t_end: float
    count: int


@dataclass(frozen=True)
class FlightNote:
    """Lifecycle event: start / restart / replay_gap / crash / stop."""

    seq: int
    t: float
    kind: str
    detail: str


@dataclass(frozen=True)
class HealthIncident:
    """One classified live-health finding (the health plane's record).

    Emitted by the watchtower (:mod:`hbbft_tpu_torch.obs.watch`) into its own
    journal, and by a node's runtime at local health transitions, so the
    online detection trail is as durable and auditable as the protocol
    evidence it points at.  ``key`` is the stable dedup identity: one
    underlying fault yields ONE incident even across poll ticks, and a
    replayed journal re-yields the identical key."""

    seq: int
    t: float
    source: str          # who raised it: "watchtower" or a node id
    kind: str            # classification: equivocation / straggler / …
    severity: str        # "info" | "warn" | "fault" | "fork"
    subject: str         # the implicated node / peer / rule subject
    key: str             # stable dedup identity of the finding
    detail: str


@dataclass(frozen=True)
class PerfSnapshot:
    """One performance-plane sampling window (the perf plane's record).

    Journaled every N-th sample by :class:`hbbft_tpu_torch.obs.perf.PerfPlane`
    so post-hoc forensics can line capacity history up against the
    fault/commit timeline.  ``doc`` is the JSON-encoded per-layer
    utilization + per-segment breakdown (a string, not a dict: flight
    records must stay hashable for the wire-completeness contract)."""

    seq: int
    t: float
    source: str          # the sampling node (recorder identity)
    window_s: float      # wall seconds covered by this window
    cpu_frac: float      # whole-process CPU fraction over the window
    headroom: float      # 1 - max layer utilization (the slack scalar)
    doc: str             # JSON: {"layers": {...}, "segments": {...}}


RECORD_TYPES = (FlightHello, FlightMsg, FlightCommit, FlightFault,
                FlightSpan, FlightNote, FlightTrace, HealthIncident,
                PerfSnapshot)


def record_as_dict(rec: Any) -> Dict[str, Any]:
    """JSON-safe dict view of a record (``/flight`` tail + audit JSON):
    message payloads are summarized as digest+size, not inlined."""
    out: Dict[str, Any] = {"type": type(rec).__name__}
    for f in fields(rec):
        v = getattr(rec, f.name)
        if isinstance(v, bytes):
            out[f.name + "_sha3"] = hashlib.sha3_256(v).hexdigest()[:16]
            out[f.name + "_bytes"] = len(v)
        else:
            out[f.name] = v
    if isinstance(rec, FlightTrace):
        # trace ids are identifiers, not payloads — show them outright
        # so ``/trace`` output can be grepped by tid
        out["tids"] = [t.hex() for t in iter_tids(rec.tids)]
    return out


# ===========================================================================
# Classification helpers
# ===========================================================================


def message_epoch(msg: Any) -> Tuple[int, int]:
    """The (era, epoch) a message belongs to, via the span classifier;
    :data:`UNKNOWN_EPOCH` for control traffic."""
    from hbbft_tpu_torch.obs.spans import classify
    from hbbft_tpu_torch.protocols.sender_queue import AlgoMessage, EpochStarted

    if isinstance(msg, EpochStarted):
        return msg.key
    hit = classify(msg)
    if hit is not None:
        return (hit[0], hit[1])
    if isinstance(msg, AlgoMessage):
        # classify() unwraps AlgoMessage itself; reaching here means the
        # inner message is control/unknown too
        return (0, UNKNOWN_EPOCH)
    return (0, UNKNOWN_EPOCH)


def target_str(target: Any) -> str:
    """Deterministic descriptor of a :class:`~hbbft_tpu_torch.traits.Target`
    (``all`` / ``nodes:1,3`` / ``all_except:0``), used as the ``peer``
    field of outbound records — the auditor checks a receive's node
    against it when matching sends to receives."""
    ids = ",".join(sorted((repr(i) for i in target.ids or ()), key=str))
    if target.kind == target.ALL:
        return "all"
    if target.kind == target.ALL_EXCEPT:
        return f"all_except:{ids}"
    return f"nodes:{ids}"


def target_covers(peer_field: str, node: str) -> bool:
    """Does an outbound record's target descriptor include ``node``
    (a repr'd node id)?"""
    if peer_field == "all":
        return True
    kind, _, ids = peer_field.partition(":")
    members = set(ids.split(",")) if ids else set()
    if kind == "all_except":
        return node not in members
    return node in members


# ===========================================================================
# Recorder
# ===========================================================================


class FlightRecorder:
    """Append-only segment-rotated journal writer for ONE node.

    Thread-unsafe by design (one owner: the node's event loop / the sim's
    crank loop).  Every append is flushed so a SIGKILL loses at most the
    record being written — which the reader then skips as a torn tail.
    """

    def __init__(self, dirpath: str, node: str, *, flavor: str = "runtime",
                 clock: Optional[Callable[[], float]] = None,
                 max_segment_bytes: int = 4 * 2**20,
                 max_segments: int = 16,
                 registry: Optional[Registry] = None,
                 tail_records: int = 512):
        self.dirpath = dirpath
        self.node = node
        self.flavor = flavor
        self.clock = clock
        self.max_segment_bytes = max_segment_bytes
        self.max_segments = max_segments
        # raw records, dict-ified lazily at read time: the tail is read
        # rarely (``/flight`` tails, audits) but appended on EVERY hot-path
        # message, and an eager record_as_dict costs a sha3 per payload
        self.tail: "deque[Any]" = deque(maxlen=tail_records)
        self._seq = 0
        self._fh = None
        self._seg_bytes = 0
        self._seg_idx = 0
        self.closed = False
        r = registry if registry is not None else Registry()
        self.registry = r
        self._c_records = r.counter(
            "hbbft_obs_flight_records_total",
            "journal records appended, by record type",
            labelnames=("type",), max_label_sets=len(RECORD_TYPES) + 1)
        # pre-resolved per-type children: .labels() re-validates the
        # label set on every call, and _append is per-message hot
        self._rec_counters = {
            cls.__name__: self._c_records.labels(type=cls.__name__)
            for cls in RECORD_TYPES
        }
        self._c_bytes = r.counter(
            "hbbft_obs_flight_bytes_total",
            "journal bytes appended (framing included)")
        self._c_write_fail = r.counter(
            "hbbft_obs_flight_write_failures_total",
            "journal records lost to disk errors (open/write/flush)")
        self._c_encode_skip = r.counter(
            "hbbft_obs_flight_encode_skips_total",
            "messages journaled without payload (no wire encoding)")
        self._c_rotations = r.counter(
            "hbbft_obs_flight_rotations_total",
            "segment rotations (size cap reached)")
        self._c_truncations = r.counter(
            "hbbft_obs_flight_truncations_total",
            "journal segments deleted at digest-chain checkpoints "
            "(bounded storage; the chain head covers the history)")
        self._c_prior_indexed = r.counter(
            "hbbft_obs_flight_prior_segments_indexed_total",
            "older-incarnation segments whose commit range was indexed "
            "at startup so checkpoint truncation can reason about them "
            "across restarts")
        self._g_segments = r.gauge(
            "hbbft_obs_flight_segments",
            "journal segment files currently retained on disk")
        # highest commit-chain index per retained segment.  Segments of
        # THIS incarnation are tracked as they rotate; segments left by
        # OLDER incarnations are indexed once at startup (below) so the
        # digest-chain checkpoint truncation can retire them too — an
        # audit across restarts must not silently lose the incident
        # window, and a restart must not pin stale segments forever.
        # Older segments with no commits (or unreadable ones) stay
        # unindexed and are KEPT: the max_segments cap remains their
        # only bound, which errs on the side of preserving forensics.
        self._seg_commit_high: Dict[str, int] = {}
        self._cur_commit_high = -1
        os.makedirs(dirpath, exist_ok=True)
        self.incarnation = self._next_incarnation()
        self._index_prior_segments()
        self._open_segment()
        self.note("restart" if self.incarnation > 1 else "start",
                  f"flavor={flavor}")

    # -- lifecycle -----------------------------------------------------------

    def _next_incarnation(self) -> int:
        prev = [inc for inc, _idx, _name in self._segments()]
        return (max(prev) + 1) if prev else 1

    def _segments(self) -> List[Tuple[int, int, str]]:
        """Sorted (incarnation, index, filename) of on-disk segments."""
        out = []
        try:
            names = os.listdir(self.dirpath)
        except OSError:
            self._c_write_fail.inc()
            return []
        for name in names:
            m = _SEGMENT_RE.match(name)
            if m:
                out.append((int(m.group(1)), int(m.group(2)), name))
        return sorted(out)

    def _index_prior_segments(self) -> None:
        """Best-effort scan of older incarnations' on-disk segments for
        their highest commit index (journal-spanning retention): each
        indexed segment becomes eligible for checkpoint truncation once
        the chain passes it.  The scan is lenient on purpose — a torn
        tail still yields the commits before the tear (uncounted here:
        the audit reader is the loud pass), and an unreadable segment
        is simply kept."""
        for _inc, _idx, name in self._segments():
            try:
                with open(os.path.join(self.dirpath, name), "rb") as fh:
                    data = fh.read()
            # hblint: disable=fault-swallowed-drop (nothing dropped: an
            # unreadable prior segment stays on disk unindexed — kept,
            # not lost; the audit reader surfaces the damage loudly)
            except OSError:
                continue
            records, _torn = read_segment_bytes(data, count_torn=False)
            high = max((r.index for r in records
                        if isinstance(r, FlightCommit)), default=-1)
            if high >= 0:
                self._seg_commit_high[name] = high
                self._c_prior_indexed.inc()

    def _open_segment(self) -> None:
        name = f"seg-{self.incarnation:04d}-{self._seg_idx:06d}.fjl"
        self._seg_name = name
        self._cur_commit_high = -1
        try:
            self._fh = open(os.path.join(self.dirpath, name), "wb")
        except OSError as exc:
            self._fh = None
            self._c_write_fail.inc()
            logger.error("flight: cannot open segment %s: %s", name, exc)
        self._seg_bytes = 0
        self._seg_records = 0
        self._g_segments.set(len(self._segments()))
        # every segment self-describes (a lone rotated file still names
        # its node/incarnation)
        self._append(FlightHello(self.node, self.flavor, self.incarnation,
                                 self._next_seq(), 0.0))

    def _rotate(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                self._c_write_fail.inc()
        if self._cur_commit_high >= 0:
            self._seg_commit_high[self._seg_name] = self._cur_commit_high
        self._seg_idx += 1
        self._c_rotations.inc()
        segs = self._segments()
        while len(segs) >= self.max_segments:
            inc, idx, name = segs.pop(0)
            try:
                os.remove(os.path.join(self.dirpath, name))
            except OSError:
                self._c_write_fail.inc()
            # keep the checkpoint map in step with the disk, or
            # truncate_checkpoint would retry the missing file forever
            self._seg_commit_high.pop(name, None)
        self._open_segment()

    def close(self) -> None:
        if self.closed:
            return
        self.note("stop", "")
        self.closed = True
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                self._c_write_fail.inc()
            self._fh = None

    def flush(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                self._c_write_fail.inc()

    # -- appends -------------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _now(self, t: Optional[float] = None) -> float:
        # an explicit t wins (the drivers pass the event's own time —
        # the virtual clock under the sim, so determinism holds; the
        # capture-site clock under sockets, so the journal timestamp is
        # the event, not the append); otherwise the logical clock (the
        # NEXT record's seq) or the recorder's clock
        if t is not None:
            return t
        return float(self._seq + 1) if self.clock is None else self.clock()

    def _append(self, rec: Any) -> None:
        payload = wire.encode_message(rec)
        frame = _FRAME_HEADER.pack(len(payload),
                                   zlib.crc32(payload)) + payload
        if self._fh is not None:
            try:
                self._fh.write(frame)
                self._fh.flush()
            except (OSError, ValueError):
                self._c_write_fail.inc()
        else:
            self._c_write_fail.inc()
        self._rec_counters[type(rec).__name__].inc()
        self._c_bytes.inc(len(frame))
        # small records (the per-message hot path) go in raw and are
        # dict-ified only when the tail is read; big ones (MB-scale RBC
        # Value payloads) are summarized NOW so the tail can never pin
        # hundreds of MB of payload bytes — 512 × 4 KiB caps it at ~2 MB
        self.tail.append(rec if len(frame) <= 4096 else
                         record_as_dict(rec))
        self._seg_bytes += len(frame)
        self._seg_records += 1
        # > 1: the segment-header hello alone must never trigger a rotate
        # (a pathologically small cap would otherwise recurse forever)
        if self._seg_bytes >= self.max_segment_bytes and \
                self._seg_records > 1:
            self._rotate()

    def record_msg(self, direction: str, peer: str, message: Any,
                   t: Optional[float] = None,
                   payload: Optional[bytes] = None) -> None:
        # the receive path already HAS the wire payload it decoded the
        # message from — callers pass it to skip a re-encode per message
        if payload is None:
            try:
                payload = wire.encode_message(message)
            except TypeError:
                self._c_encode_skip.inc()
                payload = b""
        era, epoch = message_epoch(message)
        self._append(FlightMsg(self._next_seq(), self._now(t), direction,
                               peer, era, epoch, type(message).__name__,
                               payload))

    def record_commit(self, era: int, epoch: int, index: int,
                      digest: bytes, t: Optional[float] = None) -> None:
        self._append(FlightCommit(self._next_seq(), self._now(t), era,
                                  epoch, index, digest))
        if index > self._cur_commit_high:
            self._cur_commit_high = index
        self.flush()  # a commit is the record worth surviving a crash

    def truncate_checkpoint(self, min_index: int) -> int:
        """Bounded storage: delete rotated segments — of this
        incarnation AND of older incarnations indexed at startup —
        whose every commit lies below digest-chain index ``min_index``;
        the checkpointed chain (head + ``/status``) covers them.
        Older-incarnation segments that could not be indexed (no
        commits, unreadable) are kept.  The current segment is never
        deleted.  Returns how many segments were removed (each
        counted)."""
        if min_index <= 0:
            return 0
        removed = 0
        for name in sorted(self._seg_commit_high):
            if self._seg_commit_high[name] >= min_index:
                continue
            try:
                os.remove(os.path.join(self.dirpath, name))
            # hblint: disable=fault-swallowed-drop (nothing dropped: the
            # segment is already gone — the max_segments cap beat this
            # checkpoint to it; counting it as a write failure would
            # fake a disk-health signal)
            except FileNotFoundError:
                del self._seg_commit_high[name]
                continue
            except OSError:
                self._c_write_fail.inc()
                continue
            del self._seg_commit_high[name]
            removed += 1
            self._c_truncations.inc()
        if removed:
            self._g_segments.set(len(self._segments()))
        return removed

    def record_fault(self, node: str, kind: str, era: int = 0,
                     epoch: int = UNKNOWN_EPOCH,
                     t: Optional[float] = None) -> None:
        self._append(FlightFault(self._next_seq(), self._now(t), node,
                                 kind, era, epoch))

    def record_trace(self, stage: str, era: int, epoch: int, tids: bytes,
                     detail: str = "", t: Optional[float] = None) -> None:
        """One causal stage crossing (see :mod:`hbbft_tpu_torch.obs.trace`):
        ``tids`` is the concatenated 16-byte trace-id vector of every tx
        crossing ``stage`` together — one record per batch, not per tx."""
        self._append(FlightTrace(self._next_seq(), self._now(t), stage,
                                 era, epoch, STAGE_HOPS.get(stage, 0),
                                 detail, tids))

    def record_span(self, span: Any) -> None:
        """Sink for :attr:`hbbft_tpu_torch.obs.spans.SpanTracer.sink`."""
        self._append(FlightSpan(self._next_seq(), self._now(), span.name,
                                span.era, span.epoch, span.round,
                                span.t_start, span.t_end, span.count))

    def note(self, kind: str, detail: str) -> None:
        self._append(FlightNote(self._next_seq(), self._now(), kind,
                                detail))
        if kind in ("crash", "replay_gap"):
            self.flush()

    def record_incident(self, kind: str, severity: str, subject: str,
                        key: str, detail: str,
                        t: Optional[float] = None) -> None:
        """One classified health finding (see :class:`HealthIncident`);
        flushed immediately — an incident is exactly the record an
        operator reads the journal for after a crash."""
        self._append(HealthIncident(self._next_seq(), self._now(t),
                                    self.node, kind, severity, subject,
                                    key, detail))
        self.flush()

    def record_perf(self, window_s: float, cpu_frac: float,
                    headroom: float, doc: str,
                    t: Optional[float] = None) -> None:
        """One perf-plane sampling window (see :class:`PerfSnapshot`);
        not flushed eagerly — perf history is valuable but never worth a
        sync on the pump path (crash flush picks up the tail)."""
        self._append(PerfSnapshot(self._next_seq(), self._now(t),
                                  self.node, float(window_s),
                                  float(cpu_frac), float(headroom), doc))

    # -- introspection -------------------------------------------------------

    def stats_doc(self) -> Dict[str, Any]:
        return {
            "dir": self.dirpath,
            "incarnation": self.incarnation,
            "records": int(self._c_records.total()),
            "bytes": int(self._c_bytes.value()),
            "segments": len(self._segments()),
            "truncations": int(self._c_truncations.value()),
            "write_failures": int(self._c_write_fail.value()),
        }

    def tail_jsonl(self) -> str:
        """Recent records as JSONL — the ``/flight`` endpoint body."""
        return "\n".join(
            json.dumps(r if isinstance(r, dict) else record_as_dict(r))
            for r in self.tail) + ("\n" if self.tail else "")

    def trace_jsonl(self) -> str:
        """The tail's FlightTrace records only — the ``/trace``
        endpoint body (per-tx causal stages, tids in hex)."""
        rows = []
        for r in self.tail:
            if isinstance(r, FlightTrace):
                rows.append(record_as_dict(r))
            elif isinstance(r, dict) and r["type"] == "FlightTrace":
                rows.append(r)
        return "\n".join(json.dumps(d) for d in rows) + (
            "\n" if rows else "")


# ===========================================================================
# Observer: StepObserver events → journal records
# ===========================================================================


class FlightObserver(StepObserver):
    """Translate the driver-side observer hook into journal records.

    Maintains its own ledger-digest chain over committed batches (the
    same :func:`hbbft_tpu_torch.protocols.wire.batch_bytes` canonicalization
    ``NodeRuntime`` uses) so both drivers journal the identical chain.
    An optional inner :class:`~hbbft_tpu_torch.obs.spans.SpanTracer` is driven
    through the same hook and its finalized spans are journaled via the
    tracer's ``sink`` (the ``VirtualNet`` composition; ``NodeRuntime``
    drives its own tracer and wires the sink itself).
    """

    def __init__(self, recorder: FlightRecorder, spans: Any = None):
        self.recorder = recorder
        self.spans = spans
        if spans is not None:
            spans.sink = self.record_span
        self._ledger = b"\x00" * 32
        self._chain_len = 0
        self._last_key = (0, UNKNOWN_EPOCH)

    def seed_chain(self, head: bytes, chain_len: int) -> None:
        """Snapshot state-sync activation: continue the digest chain
        from an era boundary instead of genesis, so this journal's
        commit indices line up with the donors' (the auditor verifies
        the boundary against the accompanying ``statesync`` note)."""
        self._ledger = bytes(head)
        self._chain_len = int(chain_len)

    # -- StepObserver --------------------------------------------------------

    def on_message(self, sender_id: Any, message: Any,
                   t: Optional[float] = None,
                   payload: Optional[bytes] = None) -> None:
        if self.spans is not None:
            self.spans.on_message(sender_id, message, t)
        self._last_key = message_epoch(message)
        self.recorder.record_msg("in", repr(sender_id), message, t=t,
                                 payload=payload)

    def on_input(self, sender_id: Any, inp: Any,
                 t: Optional[float] = None) -> None:
        # locally-admitted contribution: journal the ingress stage of
        # every tx it carries so the critical path starts on this node
        # even without a socket client (the VirtualNet composition;
        # NodeRuntime journals ingress itself at mempool admission)
        tx = getattr(inp, "tx", None)
        if isinstance(tx, (bytes, bytearray)):
            self.recorder.record_trace("ingress", 0, UNKNOWN_EPOCH,
                                       trace_id(bytes(tx)),
                                       detail=repr(sender_id), t=t)

    def on_step(self, step: Step, t: Optional[float] = None) -> None:
        from hbbft_tpu_torch.obs.spans import _batch_key

        if self.spans is not None:
            self.spans.on_step(step, t)  # finalized spans → sink
        for fault in step.fault_log:
            # a Step's faults arose while handling the last inbound
            # message: its (era, epoch) places the evidence on the
            # timeline (UNKNOWN_EPOCH for input-driven steps)
            self.recorder.record_fault(repr(fault.node_id),
                                       fault.kind.name,
                                       *self._last_key, t=t)
        for out in step.output:
            key = _batch_key(out)
            if key is None:
                continue
            era, epoch, _complete = key
            all_txs = getattr(out, "all_txs", None)
            if all_txs is not None:
                tids = pack_tids(trace_id(tx) for tx in all_txs())
                if tids:
                    self.recorder.record_trace("commit", era, epoch,
                                               tids, t=t)
            self._ledger = hashlib.sha3_256(
                self._ledger + wire.batch_bytes(out)).digest()
            self.recorder.record_commit(era, epoch, self._chain_len,
                                        self._ledger, t=t)
            self._chain_len += 1
        for tm in step.messages:
            self.recorder.record_msg("out", target_str(tm.target),
                                     tm.message, t=t)

    def on_note(self, kind: str, detail: str,
                t: Optional[float] = None) -> None:
        self.recorder.note(kind, detail)

    # -- plumbing ------------------------------------------------------------

    def record_span(self, span: Any) -> None:
        self.recorder.record_span(span)

    @property
    def chain_head(self) -> bytes:
        return self._ledger

    @property
    def chain_len(self) -> int:
        return self._chain_len

    def close(self) -> None:
        self.recorder.close()


# ===========================================================================
# Reader
# ===========================================================================

_c_torn = DEFAULT.counter(
    "hbbft_obs_flight_torn_tails_total",
    "journal segments whose tail was truncated/corrupt mid-record "
    "(reader skipped the tail loudly)")


def read_segment_bytes(data: bytes,
                       count_torn: bool = True) -> Tuple[List[Any], bool]:
    """Parse one segment's bytes into records.

    Returns ``(records, torn)``: a mid-record truncation, CRC mismatch,
    or undecodable payload ends the segment — ``torn`` is True, the
    damage is counted (``hbbft_obs_flight_torn_tails_total``) and logged,
    and everything before the tear is returned.  Never raises on corrupt
    input.  ``count_torn=False`` skips the counter/log (the recorder's
    lenient startup index pass re-reads segments the audit reader will
    count loudly later — double-counting would fake journal damage).
    """
    records: List[Any] = []
    pos = 0
    n = len(data)
    max_record = _max_record_bytes()
    while pos < n:
        if pos + _FRAME_HEADER.size > n:
            break  # torn: header cut
        length, crc = _FRAME_HEADER.unpack_from(data, pos)
        if length > max_record or pos + 8 + length > n:
            break  # torn: absurd length or payload cut
        payload = data[pos + 8: pos + 8 + length]
        if zlib.crc32(payload) != crc:
            break  # torn: bit rot / partial overwrite
        try:
            # lift the per-blob cap to the record's own CRC-validated
            # length: a legally-journaled near-cap message embeds blobs
            # above MAX_BLOB_BYTES and must not read back as "torn"
            records.append(wire.decode_message(
                payload, max_bytes=max_record, max_blob=len(payload)))
        # hblint: disable=fault-swallowed-drop (accounted two lines down:
        # every break lands in the torn branch that counts
        # hbbft_obs_flight_torn_tails_total and warns)
        except (ValueError, TypeError):
            break  # torn: framing intact but payload undecodable
        pos += 8 + length
    torn = pos < n
    if torn and count_torn:
        _c_torn.inc()
        logger.warning(
            "flight: torn journal tail — %d trailing bytes skipped "
            "after %d records", n - pos, len(records))
    return records, torn


@dataclass
class Journal:
    """One node's parsed journal: records tagged with incarnation."""

    path: str
    node: str
    flavor: str
    records: List[Tuple[int, Any]]   # (incarnation, record)
    torn_tails: int
    incarnations: List[int]

    @property
    def starts(self) -> int:
        return len(self.incarnations)


def read_journal(dirpath: str) -> Journal:
    """Parse every segment of one node's journal directory."""
    segs = []
    for name in sorted(os.listdir(dirpath)):
        m = _SEGMENT_RE.match(name)
        if m:
            segs.append((int(m.group(1)), int(m.group(2)), name))
    segs.sort()
    if not segs:
        raise FileNotFoundError(f"no journal segments in {dirpath!r}")
    records: List[Tuple[int, Any]] = []
    torn = 0
    node = flavor = "?"
    incs: List[int] = []
    for inc, _idx, name in segs:
        with open(os.path.join(dirpath, name), "rb") as fh:
            data = fh.read()
        recs, was_torn = read_segment_bytes(data)
        torn += 1 if was_torn else 0
        if inc not in incs:
            incs.append(inc)
        for rec in recs:
            if isinstance(rec, FlightHello):
                node, flavor = rec.node, rec.flavor
            records.append((inc, rec))
    return Journal(path=dirpath, node=node, flavor=flavor,
                   records=records, torn_tails=torn, incarnations=incs)


def find_journal_dirs(root: str) -> List[str]:
    """``root`` itself if it holds segments, else its segment-holding
    children (the ``examples/cluster.py`` layout: ``root/node-N/``)."""
    def has_segments(d: str) -> bool:
        try:
            return any(_SEGMENT_RE.match(n) for n in os.listdir(d))
        # hblint: disable=fault-swallowed-drop (directory probe: not-a-
        # journal-dir is the expected negative, surfaced by the caller
        # as "no journal segments under …" / audit exit status 2)
        except OSError:
            return False

    if has_segments(root):
        return [root]
    out = []
    try:
        children = sorted(os.listdir(root))
    # hblint: disable=fault-swallowed-drop (same probe: an unreadable
    # root returns empty and the audit entry point exits 2 loudly)
    except OSError:
        return []
    for child in children:
        d = os.path.join(root, child)
        if os.path.isdir(d) and has_segments(d):
            out.append(d)
    return out

"""NodeRuntime: host a sans-I/O consensus protocol on real sockets.

The runtime owns the event loop the :class:`~hbbft_tpu_torch.traits.Step`
contract demands: it feeds received wire bytes into a
:class:`~hbbft_tpu_torch.protocols.sender_queue.SenderQueue`-wrapped algorithm
(QHB/DHB/HB — anything ``SenderQueue`` can wrap), resolves each outgoing
``Target::All/AllExcept/Node`` against the transport's peer set, and
encodes every message exactly once per payload.

Since the epoch-pipelined scheduler landed, the protocol no longer runs
inside transport callbacks: every event is queued on a
:class:`~hbbft_tpu_torch.net.scheduler.StepPump`, whose worker thread runs the
state machine (threshold crypto included) off the event loop, keeps up to
``pipeline_depth`` epochs in flight, resolves cross-epoch batched share
verifications once per iteration, and coalesces each iteration's
outbound messages into per-peer MSG_BATCH frames.

Catch-up (the ``EpochStarted`` path):

- every connection hello carries the sender's current (era, epoch);
- a hello *above* a peer's recorded key is fed to the SenderQueue as a
  normal ``EpochStarted`` (releasing held-back messages);
- a hello *below* it means the peer restarted: the runtime rewinds the
  SenderQueue via :meth:`SenderQueue.reinit_peer`, handing it the replay
  log of recently-sent (key, message) pairs it retains per peer.  The
  restarted peer then replays the protocol from its announced key, with
  the backlog flowing in epoch order as it announces progress — a node
  restarted from scratch at (0, 0) recovers every batch as long as the
  replay retention covers the history.

Client traffic (``TX``/``STATUS_REQ`` frames) is admitted through a
bounded dedup'd :class:`~hbbft_tpu_torch.net.client.Mempool` — the backpressure
boundary — and committed batches are pushed back to every connected client
as ``TX_COMMIT`` digests, which is what the client's latency measurement
keys on.  A running SHA3 chain over committed batches (``ledger digest``)
makes cross-node batch-identity a one-line comparison.

The port's copy of the JAX package's module.  Its device work is the
stack's: the pump's deferred seam resolves every share set in flight in
one ``crypto/batch.py`` ``verify_dec_share_sets`` call on the DHB's
``device`` (on a card, each share-set fold is one ``ladder_window``
launch), and VID retrieval reconstructs on the same device.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import struct
import time
from collections import OrderedDict
from typing import (
    Any, Callable, Dict, FrozenSet, Hashable, List, Optional, Tuple,
)

from hbbft_tpu_torch.net import framing
from hbbft_tpu_torch.net.client import Mempool, tx_digest
from hbbft_tpu_torch.net.degrade import attach_runtime as _attach_degrade
from hbbft_tpu_torch.net.retrieve import RetrieveService, RetrievedPayload
from hbbft_tpu_torch.net.scheduler import StepPump
from hbbft_tpu_torch.net.statesync import SnapshotStore
from hbbft_tpu_torch.net.transport import ClientConn, EraKeyRing, Transport
from hbbft_tpu_torch.snapshot import capture_join_snapshot
from hbbft_tpu_torch.obs.flight import FlightObserver, FlightRecorder
from hbbft_tpu_torch.obs.http import ObsServer
from hbbft_tpu_torch.obs.metrics import MetricAttr, Registry, fault_counter
from hbbft_tpu_torch.obs.perf import PerfPlane
from hbbft_tpu_torch.obs.spans import SpanTracer
from hbbft_tpu_torch.obs.trace import trace_id
from hbbft_tpu_torch.ops import rs as _rs
from hbbft_tpu_torch.parallel import mesh as _mesh
from hbbft_tpu_torch.protocols import wire
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    DhbBatch,
    DynamicHoneyBadger,
)
from hbbft_tpu_torch.protocols.honey_badger import Batch as HbBatch, HoneyBadger
from hbbft_tpu_torch.fault_log import FaultKind
from hbbft_tpu_torch.protocols.queueing_honey_badger import (
    PipelineInput,
    QhbBatch,
    TxInput,
    _de_txs,
)
from hbbft_tpu_torch.protocols.vid import (
    VidCertReady,
    VidDisperse,
    VidQhbBatch,
    VidQueueingHoneyBadger,
    VidRetrieve,
    VidShard,
    payload_digest,
)
from hbbft_tpu_torch.protocols.sender_queue import (
    AlgoMessage,
    EpochStarted,
    SenderQueue,
    _algo_key,
    _algo_window,
    message_key,
)
from hbbft_tpu_torch.traits import Step


class _PumpOutcome:
    """One pump iteration's deferred side effects, applied on the event
    loop after the worker thread returns: coalesced outbound payloads per
    destination (insertion-ordered) and client commit notifications."""

    __slots__ = ("frames", "frames_delayed", "commits", "sheds", "cpu_s")

    def __init__(self):
        self.frames: Dict[NodeId, List[bytes]] = {}
        # payloads held back by class-selective shaping (pump_flush
        # schedules them `aba_out_delay_s` later, out of band so they
        # never head-block the fast classes)
        self.frames_delayed: Dict[NodeId, List[bytes]] = {}
        self.commits: List[Tuple[int, int, List[bytes]]] = []
        # digests of mempool-shed txs: clients are notified (ACK_SHED
        # push) so their commit waits fail fast instead of timing out
        self.sheds: List[bytes] = []
        # CPU seconds this iteration actually burned (thread time, immune
        # to preemption on a contended host) — drives the pump's
        # inline-vs-executor decision
        self.cpu_s: float = 0.0

NodeId = Hashable
EpochKey = Tuple[int, int]
Addr = Tuple[str, int]

logger = logging.getLogger("hbbft_tpu_torch.net")


def pick_shed_peers(
    backlogs: Dict[Any, float],
    threshold_s: float,
    max_shed: int,
    already: FrozenSet[Any] = frozenset(),
) -> FrozenSet[Any]:
    """Which peers a VID proposer may skip when fanning out this root's
    dispersal shards.

    A dispersal beyond the cert's ``n − f`` voters is pure availability
    insurance, so frames bound for a congested link are the one place the
    protocol can legally shed load: the skipped peer retrieves the
    payload lazily after ordering the commitment.  Classic RBC has no
    such slack — every payload frame is on the ordering critical path.

    The root's prior shed set is reused (and extended, within budget) so
    a re-dispersal of the same root never exceeds ``max_shed`` distinct
    peers total; worst links are shed first."""
    shed = set(already)
    for peer, lag in sorted(backlogs.items(), key=lambda kv: (-kv[1],
                                                              repr(kv[0]))):
        if len(shed) >= max_shed:
            break
        if peer in shed or lag < threshold_s:
            continue
        shed.add(peer)
    return frozenset(shed)


class NodeRuntime:
    """One networked consensus node: SenderQueue-wrapped algorithm +
    :class:`Transport` + client admission."""

    def __init__(
        self,
        algo: Any,
        cluster_id: bytes,
        *,
        seed: int = 0,
        mempool: Optional[Mempool] = None,
        make_tx_input: Callable[[bytes], Any] = TxInput,
        replay_retain_epochs: int = 64,
        replay_retain_bytes: int = 0,
        on_batch: Optional[Callable[[Any], None]] = None,
        trace=None,
        cost_model=None,
        registry: Optional[Registry] = None,
        digest_chain_retain: int = 4096,
        flight_dir: Optional[str] = None,
        flight_max_segment_bytes: int = 4 * 2**20,
        flight_max_segments: int = 16,
        flight_retain_batches: int = 0,
        ledger_seed: Optional[Tuple[bytes, int]] = None,
        sync_chunk_bytes: int = 32 * 1024,
        peer_addr_book: Optional[
            Callable[[NodeId], Optional[Addr]]
        ] = None,
        pipeline_depth: int = 1,
        step_delay_s: float = 0.0,
        aba_out_delay_s: float = 0.0,
        aba_out_classes: str = "",
        auth: bool = True,
        auth_grace_s: float = 30.0,
        degrade: bool = True,
        degrade_kwargs: Optional[Dict[str, Any]] = None,
        vid_retrieve_kwargs: Optional[Dict[str, Any]] = None,
        vid_shed_backlog_s: float = 0.25,
        **transport_kwargs,
    ):
        self.sq = algo if isinstance(algo, SenderQueue) else SenderQueue(algo)
        # VID mode (protocols/vid.py + net/retrieve.py): the wrapped
        # algorithm orders constant-size (root, cert) commitments and the
        # runtime owns lazy payload retrieval — fetch k shards, rebuild,
        # re-verify — off the ordering critical path.
        self._vid = isinstance(self.sq.algo, VidQueueingHoneyBadger)
        self._retrieve: Optional[RetrieveService] = None
        # root → (era, epoch) of the committed commitment awaiting its
        # payload; resolved entries are popped in _on_retrieved
        self._vid_pending: Dict[bytes, EpochKey] = {}
        if self._vid:
            self._retrieve = RetrieveService(
                self.sq.our_id(), self.sq.algo.store,
                on_note=self._vid_note, device=self.sq.algo.dhb.device,
                **(vid_retrieve_kwargs or {}))
        # Best-effort dispersal shedding: a shard bound for a peer whose
        # shaped link already has ≥ this many seconds of bulk committed
        # is dropped at dispatch (at most f peers per root, so the cert
        # stays reachable from the remaining n − f voters).  0 disables.
        # Keep the threshold SMALL: shards admitted while the backlog sits
        # just under it become a standing serialization queue that every
        # consensus control frame behind them must wait out — the
        # threshold is effectively the straggler's added ordering latency.
        self.vid_shed_backlog_s = float(vid_shed_backlog_s)
        # root → frozen shed set, LRU-capped: a re-dispersal of the same
        # root (excluded proposer re-sampling its queue) reuses the same
        # budget instead of shedding a fresh f peers each time
        self._vid_shed_roots: "OrderedDict[bytes, FrozenSet[Any]]" = (
            OrderedDict())
        self._vid_sheds = 0
        # Epoch-pipelined scheduler (net/scheduler.py): every protocol
        # interaction is queued and processed in batches on the pump's
        # worker thread; with pipeline_depth > 1 the pump keeps that many
        # epochs proposed-into at once.  Depth 1 preserves the sequential
        # one-epoch-at-a-time behavior.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # chaos/scenario knob: sleep this long before every pump
        # iteration — models an overloaded/underprovisioned validator
        # (the bench's coin-exercise run slows one node until its own
        # proposal races the Subset give-up threshold, the honest way to
        # split ABA votes and flip real threshold coins)
        self.step_delay_s = float(step_delay_s)
        # message-class-selective shaping: outbound BINARY-AGREEMENT
        # traffic is held this long while RBC and the rest flow normally —
        # decorrelates ABA progress from RBC delivery, which is what
        # genuinely splits Subset's accept/give-up votes (plain per-link
        # delay cannot: the RBC echo relay re-equalizes deliveries).
        # `aba_out_classes` narrows the hold to specific phases (comma
        # list of span names, e.g. "aba_conf" delays only decisions — the
        # bench's coin-exercise shape — while BVal/Aux propagate freely
        # so neither side of a vote split gets flooded out); empty = all
        # aba_* classes.  First member of the ROADMAP's link-shaping
        # policy zoo.
        self.aba_out_delay_s = float(aba_out_delay_s)
        self.aba_out_classes = frozenset(
            c.strip() for c in aba_out_classes.split(",") if c.strip()
        )
        # tick_s: the degradation controller needs periodic pump wakes
        # to recover on an idle node (see StepPump), VID retrieval
        # retries need the same heartbeat, and the always-on perf plane
        # samples on it (a stalled sampler would freeze /status headroom
        # exactly when an operator looks)
        self.pump = StepPump(self, pipeline_depth=self.pipeline_depth,
                             tick_s=0.25)
        self._out: Optional[_PumpOutcome] = None
        # park threshold-decrypt share verification in the protocols so
        # the pump can resolve ALL in-flight epochs' sets in one merged
        # crypto.batch call per iteration (no-op for unencrypted runs)
        self._enable_deferred_crypto()
        # one registry per node: every layer below (transport, mempool,
        # span tracer, fault tallies) registers onto it, and /metrics
        # exposes it live (see hbbft_tpu_torch.obs)
        self.registry = registry or Registry()
        self.spans = SpanTracer(self.registry, node=self.sq.our_id())
        self._c_decode = self.registry.counter(
            "hbbft_node_decode_failures_total",
            "undecodable or protocol-rejected peer messages")
        self._c_send_fail = self.registry.counter(
            "hbbft_node_send_failures_total",
            "outbound frames dropped (frame cap)")
        self._c_replay_gaps = self.registry.counter(
            "hbbft_node_replay_gaps_total",
            "peer restarts whose gap exceeded replay retention "
            "(the peer cannot catch up from here; remedy: snapshot "
            "state-sync — net/statesync.py)")
        self._c_replay_trunc = self.registry.counter(
            "hbbft_node_replay_truncations_total",
            "replay-log entries truncated by the byte cap "
            "(replay_retain_bytes) before their epoch retention expired")
        self._c_committed = self.registry.counter(
            "hbbft_node_committed_txs_total", "transactions committed")
        self._c_faults = fault_counter(self.registry)
        # hbbft_guard_*: the overload-defense metric family (transport
        # ingress budgets register theirs on the same registry below)
        self._c_sq_evict = self.registry.counter(
            "hbbft_guard_senderq_evictions_total",
            "SenderQueue backlog entries front-chopped at the per-peer "
            "cap (the peer recovers via snapshot state-sync)",
            labelnames=("peer",), max_label_sets=33)
        self._c_proto_drops = self.registry.counter(
            "hbbft_guard_protocol_drops_total",
            "messages dropped by protocol-layer flood budgets "
            "(hb_future = HoneyBadger future-epoch budget, subset = "
            "per-ACS sender budget)",
            labelnames=("kind",), max_label_sets=4)
        for k in ("hb_future", "subset"):
            self._c_proto_drops.labels(kind=k)
        # hbbft_rbc_*: erasure hot-path accounting.  ops/rs.py keeps
        # deterministic plain-int counters (no registry dependency, no
        # clocks — the module is in the determinism lint's scope); each
        # scrape folds the delta since the last sync into real counters.
        # The rs counters are process-global, so in-process multi-node
        # harnesses see the shared total on every node's registry.
        self._c_rbc_calls = self.registry.counter(
            "hbbft_rbc_erasure_calls_total",
            "erasure encode/decode matrix applications by backend",
            labelnames=("backend",), max_label_sets=4)
        self._c_rbc_bytes = self.registry.counter(
            "hbbft_rbc_erasure_bytes_total",
            "payload bytes through the erasure hot path by backend",
            labelnames=("backend",), max_label_sets=4)
        self._rs_stats_last = _rs.stats_snapshot()
        # hbbft_mesh_*: device-mesh collective accounting for the sharded
        # epoch phases (parallel/mesh.py keeps the same deterministic
        # plain-int counters as ops/rs.py; deltas fold here per scrape).
        # Zero on single-device runs — nonzero only when a node runs the
        # mesh-sharded epoch path.
        self._c_mesh_coll = self.registry.counter(
            "hbbft_mesh_collectives_total",
            "mesh-spanning collective launches by sharded epoch phase",
            labelnames=("phase",), max_label_sets=5)
        self._c_mesh_bytes = self.registry.counter(
            "hbbft_mesh_gather_bytes_total",
            "bytes returned by sharded-phase collectives (computed "
            "statically from array shapes, not traced)",
            labelnames=("phase",), max_label_sets=5)
        for ph in ("rbc", "aba", "coin", "decrypt"):
            self._c_mesh_coll.labels(phase=ph)
            self._c_mesh_bytes.labels(phase=ph)
        self._mesh_stats_last = _mesh.stats_snapshot()
        # hbbft_vid_*: dispersal/retrieval accounting.  The protocol and
        # service layers keep deterministic plain-int counters (both are
        # clock-free); scrapes fold the deltas here,
        # same pattern as the rs/mesh counters above.
        self._c_vid = None
        self._vid_stats_last: Dict[str, int] = {}
        if self._vid:
            self._c_vid = self.registry.counter(
                "hbbft_vid_events_total",
                "verifiable-information-dispersal events by kind "
                "(disperse / vote_cast / cert = proposer+voter side; "
                "retrieve / retrieved / retry / failure = requester "
                "side; shard_served / refusal / quota_drop = donor "
                "side; disperse_shed = best-effort dispersals skipped "
                "toward backlogged links; bad_shard / mismatch = "
                "Byzantine evidence; stray_shard / store_eviction = "
                "hygiene)",
                labelnames=("kind",), max_label_sets=16)
            for k in self._vid_stats():
                self._c_vid.labels(kind=k)
        self.registry.register_callback(self._refresh_gauges)
        # `is not None`, not `or`: Mempool defines __len__, so a freshly
        # configured (empty → falsy) instance would be silently replaced
        # by the default, discarding its max_tx_bytes sizing
        self.mempool = mempool if mempool is not None else Mempool()
        self.mempool.bind_registry(self.registry)
        # the oversized-frame drop in _dispatch is a last-resort guard,
        # not a config escape hatch: a proposal of batch_size max-size txs
        # must fit the wire blob cap with margin (TLV + TPKE overhead),
        # or an honest proposer could wedge its own epochs
        # (in VID mode proposals are constant-size commitments — the
        # payload travels as per-node shards of ~1/k its size — so
        # MB-scale batch shapes the classic check forbids are exactly
        # the point; the shard frames stay under the cap by design)
        batch_size = getattr(self.sq.algo, "batch_size", None)
        if batch_size is not None and not self._vid:
            worst = batch_size * (self.mempool.max_tx_bytes + 16)
            if worst > wire.MAX_BLOB_BYTES // 2:
                raise ValueError(
                    f"batch_size {batch_size} × max_tx_bytes "
                    f"{self.mempool.max_tx_bytes} = {worst}B can exceed "
                    f"half the wire blob cap ({wire.MAX_BLOB_BYTES}B): "
                    f"lower one of them (Mempool(max_tx_bytes=…))"
                )
        self.make_tx_input = make_tx_input
        self.replay_retain_epochs = replay_retain_epochs
        # bounded storage: a per-peer byte ceiling on the replay log that
        # truncates EARLIER than the epoch retention when a peer's
        # backlog grows fat (0 = epochs-only).  Truncated entries are
        # counted — a peer whose gap now exceeds what the log covers
        # recovers via snapshot state-sync instead of replay.
        self.replay_retain_bytes = int(replay_retain_bytes)
        self.flight_retain_batches = int(flight_retain_batches)
        self.on_batch = on_batch
        self.batches: List[Any] = []
        self.ledger_digest = b"\x00" * 32
        # era-boundary join snapshots: captured at every completed DKG
        # rotation, served to joiners over SYNC client frames
        self.sync_store = SnapshotStore(self.registry,
                                        chunk_bytes=sync_chunk_bytes)
        self.peer_addr_book = peer_addr_book
        # the digest chain is CHECKPOINTED, not unbounded: only the last
        # `digest_chain_retain` entries stay in memory; `chain_len` (the
        # total) and `ledger_digest` (the head) never truncate, and the
        # flight journal keeps the full per-batch record on disk
        self.digest_chain_retain = max(1, digest_chain_retain)
        self._digest_chain: List[str] = []
        self._digest_chain_offset = 0
        # black-box flight recorder (obs.flight): journals every message,
        # commit, fault, span and lifecycle event for offline forensics
        self.flight: Optional[FlightObserver] = None
        if flight_dir:
            recorder = FlightRecorder(
                flight_dir, node=repr(self.sq.our_id()),
                flavor="runtime", clock=time.time,
                max_segment_bytes=flight_max_segment_bytes,
                max_segments=flight_max_segments,
                registry=self.registry,
            )
            self.flight = FlightObserver(recorder)
            self.spans.sink = self.flight.record_span
        # snapshot state-sync activation: continue the ledger-digest
        # chain from the snapshot's era boundary instead of genesis.
        # The flight journal is seeded with the same position and notes
        # the boundary so the forensic auditor can verify the join
        # against the donors' chains (obs.audit).
        if ledger_seed is not None:
            head, chain_len = ledger_seed
            if len(head) != 32 or chain_len < 0:
                raise ValueError("ledger_seed must be (32-byte head, len)")
            self.ledger_digest = bytes(head)
            self._digest_chain_offset = int(chain_len)
            if self.flight is not None:
                self.flight.seed_chain(self.ledger_digest,
                                       self._digest_chain_offset)
                self.flight.on_note(
                    "statesync",
                    f"index={self._digest_chain_offset} "
                    f"head={self.ledger_digest.hex()}")
        # per-peer replay log of recently sent consensus messages, in send
        # order: the reinit_peer history (see module docstring).  Entries
        # are (key, message, payload) — the companion set dedups on
        # (key, payload) BYTES so reinit re-sends don't duplicate the log
        # (hashing the wire bytes is C-speed; hashing the frozen-dataclass
        # chains recursively was a measurable slice of _dispatch)
        self._replay: Dict[NodeId, List[Tuple[EpochKey, Any, bytes]]] = {}
        self._replay_seen: Dict[NodeId, set] = {}
        self._replay_bytes: Dict[NodeId, int] = {}
        self._clients: set = set()
        # transport authentication (see transport module security
        # model): the per-era keypairs the protocol already carries
        # become the handshake's WHO.  Wired whenever the wrapped stack
        # exposes a NetworkInfo; a bare test harness without one keeps
        # the legacy identification-only handshake, as does auth=False.
        self._cluster_id = bytes(cluster_id)
        self._era_keys: Optional[EraKeyRing] = None
        if auth and self._auth_netinfo() is not None:
            self._era_keys = EraKeyRing(self._era_key_provider,
                                        grace_s=auth_grace_s)
            transport_kwargs.setdefault("auth_sign", self._auth_sign)
            transport_kwargs.setdefault("auth_verify", self._auth_verify)
        self.transport = Transport(
            our_id=self.sq.our_id(),
            cluster_id=cluster_id,
            seed=seed,
            hello_key=self.current_key,
            on_peer_message=self._on_peer_message,
            on_peer_batch=self._on_peer_batch,
            on_peer_hello=self._on_peer_hello,
            on_client_frame=self._on_client_frame,
            on_client_gone=self._on_client_gone,
            trace=trace,
            cost_model=cost_model,
            registry=self.registry,
            peer_resolver=self._resolve_peer,
            **transport_kwargs,
        )
        # overload-defense wiring: the transport meters per-peer ingress
        # (frames admitted here retire in _process_peer_message), the
        # runtime reports decode-garbage strikes back to it, and every
        # guard escalation is journaled through the pump so the forensic
        # auditor can attribute the incident to the offending peer
        self.transport.ingress.track_inflight = True
        self.transport.ingress.on_event = self._on_guard_event
        self.sq.on_evict = self._on_senderq_evict
        # a shed tx was pump-enqueued at admission: pull it back out of
        # the protocol queue too, or every shed would grow the queue
        # past the mempool ceiling (an unproposed shed tx then truly
        # never commits; one already riding an open epoch still lands —
        # proposals cannot be recalled)
        self.mempool.on_shed = self._on_mempool_shed
        self._obs_server: Optional[ObsServer] = None
        self.obs_addr: Optional[Addr] = None
        # Always-on pump segment accounting: the env-gated
        # HBBFT_PUMP_TIMING accumulators' low-overhead production
        # sibling.  Observed once per pump iteration per segment
        # (aggregated within the iteration), so the cost is a handful of
        # perf_counter reads per batch, not per event — and the per-tx
        # critical path's pump-queue component (obs.critpath)
        # cross-checks against a live metric.
        self._h_pump_seg = self.registry.histogram(
            "hbbft_pump_segment_seconds",
            "seconds per pump segment per iteration (msg/input/hello/"
            "startup/guard/shed = event dispatch by kind; deferred = "
            "merged threshold-crypto drain; flush = coalesced egress "
            "writes; queue_wait = the iteration's max inbox wait; "
            "recv = transport frame receive)",
            labelnames=("segment",),
            buckets=(1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0),
            max_label_sets=12)
        self._pump_seg = {
            k: self._h_pump_seg.labels(segment=k)
            for k in ("msg", "input", "hello", "startup", "guard",
                      "shed", "deferred", "flush", "queue_wait", "recv")
        }
        # HBBFT_PUMP_TIMING=1: accumulate per-segment thread time in the
        # pump (perf diagnosis; dumped by run_node on shutdown)
        self._pump_timing: Optional[Dict[str, float]] = (
            {} if os.environ.get("HBBFT_PUMP_TIMING") else None
        )
        self.transport.timing = self._pump_timing
        self.transport.seg_recv = self._pump_seg["recv"].observe
        self._decode_cache: Dict[bytes, Any] = {}
        # HBBFT_PUMP_RECORD=<dir>: journal pump events as JSONL for
        # offline replay profiling (only with timing enabled)
        self._pump_record = None
        rec_dir = os.environ.get("HBBFT_PUMP_RECORD")
        if rec_dir and self._pump_timing is not None:
            os.makedirs(rec_dir, exist_ok=True)
            self._pump_record = open(
                os.path.join(rec_dir,
                             f"events-{self.sq.our_id()!r}.jsonl"), "w")
        # performance plane (obs/perf.py): always-on counter-snapshot
        # profiler + headroom model, sampled on the pump heartbeat
        # (pump_tick) and served at /perf.  Built BEFORE the controller
        # so the degradation ladder's raise arm can consume its measured
        # headroom as the slack signal.
        self.perf = PerfPlane(
            self.registry, self.sq.our_id(),
            pump_cpu_fn=lambda: self.pump.cpu_seconds,
            pump_stats_fn=lambda: (self.pump.iterations,
                                   self.pump.offloaded),
            record=(self.flight.recorder.record_perf
                    if self.flight is not None else None))
        # guard-driven adaptive degradation (net/degrade.py): shrink the
        # proposed batch size and mempool admission under sustained
        # guard pressure, restore when it clears — and, with a perf
        # plane measuring slack, raise toward the configured ceilings
        # under sustained benign headroom.  None when the wrapped
        # protocol exposes no batch size (nothing to degrade) or
        # degrade=False.
        self.degrade = (_attach_degrade(self, **(degrade_kwargs or {}))
                        if degrade else None)
        # live health plane (obs/watch.py): last locally-evaluated
        # health status, updated on the pump heartbeat so ok↔degraded
        # transitions are journaled as HealthIncident records from the
        # one thread allowed to append
        self._health_status = "ok"
        self._health_transitions = 0

    # -- transport authentication --------------------------------------------

    def _auth_netinfo(self):
        """The NetworkInfo carrying this era's keypairs, if the wrapped
        stack has one (DynamicHoneyBadger or plain HoneyBadger)."""
        dhb = self._inner_dhb()
        if dhb is not None:
            return dhb.netinfo
        return getattr(self._inner_hb(), "netinfo", None)

    def _era_key_provider(self) -> Tuple[int, Dict[NodeId, Any]]:
        """EraKeyRing source: the CURRENT era's plain public-key map —
        the same map the dynamic-peer resolver consults for membership."""
        era, _epoch = self.current_key()
        ni = self._auth_netinfo()
        return int(era), (dict(ni.public_key_map())
                          if ni is not None else {})

    def _auth_sign(self, cluster_id: bytes, nonce: bytes,
                   session: bytes) -> Tuple[int, bytes]:
        """Answer a handshake CHALLENGE: sign the transcript with this
        node's current per-era secret key (transport auth callback)."""
        ni = self._auth_netinfo()
        if ni is None:
            raise framing.FrameError(
                "challenged but this node carries no era keypair")
        era, _epoch = self.current_key()
        transcript = framing.auth_transcript(
            cluster_id, nonce, session, self.our_id(),
            framing.ROLE_NODE, int(era))
        return int(era), ni.secret_key().sign(transcript).to_bytes()

    def _auth_verify(self, node_id: NodeId, role: int, era: int,
                     sig_bytes: bytes, nonce: bytes,
                     session: bytes) -> str:
        """Judge an inbound handshake proof (transport auth callback):
        ``ok`` / ``stale`` (previous-era key inside the rotation grace
        window, or an honest-but-behind era claim under a current key)
        / ``bad_sig`` / ``unknown_key``."""
        from hbbft_tpu_torch.crypto import tc

        try:
            sig = tc.Signature.from_bytes(bytes(sig_bytes))
            transcript = framing.auth_transcript(
                self._cluster_id, nonce, session, node_id, role,
                int(era))
        # hblint: disable=fault-swallowed-drop (the verdict return IS
        # the accounting: the transport counts every non-ok verdict
        # under hbbft_guard_auth_failures_total{reason=...} and
        # journals the endpoint)
        except (ValueError, IndexError, framing.FrameError):
            # IndexError: pairing libs raise it on empty/truncated
            # signature blobs rather than ValueError
            return "bad_sig"
        candidates = self._era_keys.lookup(node_id)
        if not candidates:
            return "unknown_key"
        era_matched = False
        for cand_era, key, stale in candidates:
            if cand_era != era:
                continue
            era_matched = True
            if key.verify(sig, transcript):
                return "stale" if stale else "ok"
        if not era_matched:
            # an honest peer behind on rotations signs its own (older)
            # era view; a signature by a CURRENT-map key still proves
            # key possession — admit as stale (counted), or a restarted
            # validator could never reconnect.  A revoked key holder
            # still fails: its key is in no admissible map.
            for _cand_era, key, stale in candidates:
                if not stale and key.verify(sig, transcript):
                    return "stale"
        return "bad_sig"

    def pump_tick(self) -> None:
        """Periodic pump heartbeat (between iterations, serialized with
        pump_process): drives the degradation controller so engage AND
        recovery both proceed whether the node is busy or idle.  VID
        retrieval retries are enqueued as a pump event rather than run
        here — the tick has no _PumpOutcome to absorb Steps into."""
        # sample the perf plane FIRST: the controller's raise arm reads
        # the headroom this tick just measured, not last tick's
        self.perf.maybe_sample()
        if self.degrade is not None:
            self.degrade.tick()
        if self._retrieve is not None and self._retrieve.pending_count():
            deadline = self._retrieve.next_deadline()
            if deadline is not None and time.time() >= deadline:
                self.pump.enqueue("vid_tick")
        self._health_tick()

    def _health_issues(self) -> List[str]:
        """Locally-observable health problems, cheap enough for every
        heartbeat: the degradation controller being engaged, and the
        mempool running at ≥90% of its admission capacity."""
        issues: List[str] = []
        if self.degrade is not None and self.degrade.level:
            issues.append("degrade_active")
        cap = self.mempool.capacity
        if cap and len(self.mempool) * 10 >= cap * 9:
            issues.append("mempool_pressure")
        return issues

    def _health_tick(self) -> None:
        """Journal one HealthIncident per local ok↔degraded transition
        (pump thread — the only thread allowed to append).  Transitions,
        not levels: a sustained degrade writes one record when it
        engages and one when it recovers, never one per heartbeat."""
        issues = self._health_issues()
        status = "degraded" if issues else "ok"
        if status == self._health_status:
            return
        prev, self._health_status = self._health_status, status
        self._health_transitions += 1
        if self.flight is not None:
            me = repr(self.our_id())
            self.flight.recorder.record_incident(
                "local_health",
                "warn" if status == "degraded" else "info", me,
                f"local_health:{me}:{self._health_transitions}",
                f"{prev}->{status}"
                + (f": {','.join(issues)}" if issues else ""))

    def _vid_note(self, kind: str, detail: str) -> None:
        """RetrieveService loudness sink → flight journal (the service's
        methods only ever run on the pump thread, where appends are
        allowed)."""
        if self.flight is not None:
            self.flight.on_note(kind, detail)

    def _shed_for_disperse(
        self, root: bytes, peer_ids: List[NodeId]
    ) -> "FrozenSet[Any]":
        """The (possibly empty) set of peers to skip for this root's
        dispersal frames — see :func:`pick_shed_peers` for the policy.
        Budget is ``f``: with our own vote plus the other ``n − 1 − f``
        peers still served, the ``n − f`` cert threshold stays reachable
        even if every shed peer never sees the shard."""
        f = len(peer_ids) // 3  # n = peers + 1, so f = (n − 1) // 3
        if f <= 0:
            return frozenset()
        roots = self._vid_shed_roots
        already = roots.get(root, frozenset())
        backlogs = {p: self.transport.send_backlog_s(p) for p in peer_ids}
        shed = pick_shed_peers(
            backlogs, self.vid_shed_backlog_s, f, already)
        roots[root] = shed
        roots.move_to_end(root)
        while len(roots) > 64:
            roots.popitem(last=False)
        return shed

    def _vid_stats(self) -> Dict[str, int]:
        """The VID layers' deterministic plain-int counters, keyed by
        the ``hbbft_vid_events_total`` kind label."""
        d = self.sq.algo.disperser
        s = self._retrieve
        return {
            "disperse": d.disperses,
            "vote_cast": d.votes_cast,
            "cert": d.certs,
            "retrieve": s.retrieves,
            "retrieved": s.retrieved,
            "shard_served": s.served,
            "refusal": s.refusals,
            "quota_drop": s.quota_drops,
            "bad_shard": s.shards_bad,
            "mismatch": s.mismatches,
            "retry": s.retries,
            "failure": s.failures,
            "stray_shard": s.stray_shards,
            "store_eviction": self.sq.algo.store.evictions,
            "disperse_shed": self._vid_sheds,
        }

    # -- observability -------------------------------------------------------
    #
    # The pre-registry integer attributes survive as thin counter-backed
    # views (MetricAttr descriptors) so existing call sites — status_doc
    # consumers, tests — keep working; the registry is the single source
    # of truth.

    committed_txs = MetricAttr("_c_committed")
    decode_failures = MetricAttr("_c_decode")
    send_failures = MetricAttr("_c_send_fail")
    replay_gaps = MetricAttr("_c_replay_gaps")

    @property
    def digest_chain(self) -> List[str]:
        """The RETAINED tail of the ledger-digest chain (see
        :attr:`digest_chain_offset` for where it starts)."""
        return self._digest_chain

    @property
    def digest_chain_offset(self) -> int:
        return self._digest_chain_offset

    @property
    def chain_len(self) -> int:
        """Total batches folded into the digest chain (never truncates)."""
        return self._digest_chain_offset + len(self._digest_chain)

    @property
    def faults_observed(self) -> int:
        return int(self._c_faults.total())

    def _refresh_gauges(self) -> None:
        """Derived-state gauges, refreshed on every scrape: consensus
        position, ledger length, connection health, and the replay/catch-up
        surfaces — replay-log depth and each peer's
        last-acked (era, epoch) — now scrapeable instead of grep-able."""
        r = self.registry
        for backend, cur in _rs.stats_snapshot().items():
            last = self._rs_stats_last.get(backend, {})
            d_calls = cur["calls"] - last.get("calls", 0)
            d_bytes = cur["bytes"] - last.get("bytes", 0)
            if d_calls > 0:
                self._c_rbc_calls.labels(backend=backend).inc(d_calls)
            if d_bytes > 0:
                self._c_rbc_bytes.labels(backend=backend).inc(d_bytes)
            self._rs_stats_last[backend] = dict(cur)
        for ph, cur in _mesh.stats_snapshot().items():
            last = self._mesh_stats_last.get(ph, {})
            d_coll = cur["collectives"] - last.get("collectives", 0)
            d_bytes = cur["gather_bytes"] - last.get("gather_bytes", 0)
            if d_coll > 0:
                self._c_mesh_coll.labels(phase=ph).inc(d_coll)
            if d_bytes > 0:
                self._c_mesh_bytes.labels(phase=ph).inc(d_bytes)
            self._mesh_stats_last[ph] = dict(cur)
        if self._c_vid is not None:
            cur = self._vid_stats()
            for k, v in cur.items():
                delta = v - self._vid_stats_last.get(k, 0)
                if delta > 0:
                    self._c_vid.labels(kind=k).inc(delta)
            self._vid_stats_last = cur
            r.gauge("hbbft_vid_store_bytes",
                    "bytes held by the bounded LRU shard store").set(
                        self.sq.algo.store.bytes)
            r.gauge("hbbft_vid_pending_retrievals",
                    "committed commitments whose payload retrieval is "
                    "still in flight").set(self._retrieve.pending_count())
        era, epoch = self.current_key()
        r.gauge("hbbft_node_era", "current consensus era").set(era)
        r.gauge("hbbft_node_epoch", "current epoch within the era").set(epoch)
        r.gauge("hbbft_node_batches", "batches committed so far").set(
            len(self.batches))
        r.gauge("hbbft_node_peers_connected",
                "peers with a live outbound connection").set(sum(
                    1 for p in self.transport.peer_ids()
                    if self.transport.connected(p)))
        # pipelining health: how many epochs this node currently keeps
        # open concurrently, and how deep the pump's event backlog is
        hb = self._inner_hb()
        r.gauge("hbbft_node_epochs_in_flight",
                "epochs with live in-flight consensus state "
                "(> 1 means the pipeline is engaged)").set(
                    len(hb.epochs) if hb is not None else 0)
        r.gauge("hbbft_node_pump_backlog",
                "events queued for the step pump").set(self.pump.pending())
        g_replay = r.gauge(
            "hbbft_node_replay_log_entries",
            "retained replay-log messages per peer", labelnames=("peer",))
        # list() snapshots: the pump's worker thread mutates these dicts
        # concurrently with a scrape
        for peer, entries in list(self._replay.items()):
            g_replay.labels(peer=repr(peer)).set(len(entries))
        g_pera = r.gauge(
            "hbbft_node_peer_era",
            "last (era, epoch) each peer announced: era part",
            labelnames=("peer",))
        g_pep = r.gauge(
            "hbbft_node_peer_epoch",
            "last (era, epoch) each peer announced: epoch part",
            labelnames=("peer",))
        for peer, (p_era, p_epoch) in list(self.sq.peer_epochs.items()):
            if peer == self.our_id():
                continue
            g_pera.labels(peer=repr(peer)).set(p_era)
            g_pep.labels(peer=repr(peer)).set(p_epoch)
        # overload-defense gauges: every budgeted buffer's depth, per
        # peer — the "pinned under its cap" witnesses the chaos cells
        # (and operators) assert on
        g_sqb = r.gauge(
            "hbbft_guard_senderq_buffered",
            "SenderQueue backlog entries held for each peer "
            "(capped at buffered_cap; overflow front-chops, counted)",
            labelnames=("peer",), max_label_sets=33)
        for peer, entries in list(self.sq.buffered.items()):
            g_sqb.labels(peer=repr(peer)).set(len(entries))
        g_aba = r.gauge(
            "hbbft_guard_aba_future_buffered",
            "largest per-sender ABA future-epoch buffer across live "
            "agreement instances (capped at future_cap_per_sender)",
            labelnames=("peer",), max_label_sets=33)
        for peer, depth in self._aba_future_depths().items():
            g_aba.labels(peer=repr(peer)).set(depth)

    def _aba_future_depths(self) -> Dict[NodeId, int]:
        """max per-sender future-buffer depth over live BA instances."""
        out: Dict[NodeId, int] = {}
        hb = self._inner_hb()
        if hb is None:
            return out
        try:
            for state in list(hb.epochs.values()):
                for prop in list(state.subset.proposals.values()):
                    per: Dict[NodeId, int] = {}
                    for sender, _msg in list(prop.agreement.future):
                        per[sender] = per.get(sender, 0) + 1
                    for sender, n in per.items():
                        if n > out.get(sender, 0):
                            out[sender] = n
        # hblint: disable=fault-swallowed-drop (nothing is dropped: this
        # is a best-effort gauge sample racing the pump thread's
        # mutations; the next scrape re-reads the live state)
        except RuntimeError:
            pass
        return out

    def _inner_hb(self):
        """The innermost HoneyBadger of the wrapped stack, if any."""
        algo = self.sq.algo
        dhb = getattr(algo, "dhb", algo)
        return getattr(dhb, "hb", dhb if isinstance(dhb, HoneyBadger)
                       else None)

    def _inner_dhb(self):
        """The DynamicHoneyBadger of the wrapped stack, if any."""
        algo = self.sq.algo
        dhb = getattr(algo, "dhb", algo)
        return dhb if isinstance(dhb, DynamicHoneyBadger) else None

    def _resolve_peer(self, node_id: NodeId) -> Optional[Addr]:
        """Transport hook: may an unknown node-role hello join the peer
        set, and at what address?  Membership is consensus state — a
        node the current era's validator map names (e.g. one voted in by
        a DHB rotation) is accepted, everyone else stays rejected.  The
        address comes from the deployment's address book
        (config-derived ports for the shipped cluster tooling)."""
        if self.peer_addr_book is None or node_id == self.our_id():
            return None
        dhb = self._inner_dhb()
        if dhb is None or node_id not in dhb.netinfo.public_key_map():
            return None
        return self.peer_addr_book(node_id)

    async def start_obs(self, host: str = "127.0.0.1",
                        port: int = 0) -> Addr:
        """Serve ``/metrics``, ``/status``, ``/spans``, ``/flight``,
        ``/trace``, ``/health``, ``/perf`` (see obs.http)."""
        self._obs_server = ObsServer(
            self.registry,
            status_fn=self.status_doc,
            spans_fn=self.spans.export_jsonl,
            flight_fn=(self.flight.recorder.tail_jsonl
                       if self.flight is not None else None),
            trace_fn=(self.flight.recorder.trace_jsonl
                      if self.flight is not None else None),
            health_fn=self.health_doc,
            perf_fn=self.perf.perf_doc,
        )
        self.obs_addr = await self._obs_server.start(host, port)
        return self.obs_addr

    # -- lifecycle -----------------------------------------------------------

    def our_id(self) -> NodeId:
        return self.sq.our_id()

    def current_key(self) -> EpochKey:
        return _algo_key(self.sq.algo)

    def _enable_deferred_crypto(self) -> None:
        """Flip the wrapped protocol stack into deferred threshold-decrypt
        verification (see ``HoneyBadger.defer_decrypt``)."""
        algo = self.sq.algo
        dhb = getattr(algo, "dhb", None)
        if dhb is None and isinstance(algo, DynamicHoneyBadger):
            dhb = algo
        if dhb is not None:
            dhb.defer_decrypt_verify = True
            dhb.hb.defer_decrypt = True
        elif isinstance(algo, HoneyBadger):
            algo.defer_decrypt = True

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        addr = await self.transport.listen(host, port)
        if self.pump.task is None:
            self.pump.start()
        return addr

    def connect(self, peer_addrs: Dict[NodeId, Addr]) -> None:
        """Add peers and announce our epoch (SenderQueue startup)."""
        for peer_id, addr in peer_addrs.items():
            if peer_id != self.our_id():
                self.transport.add_peer(peer_id, addr)
        self.pump.enqueue("startup")

    async def stop(self) -> None:
        if self._obs_server is not None:
            await self._obs_server.stop()
        await self.pump.stop()
        await self.transport.stop()
        if self.flight is not None:
            self.flight.close()
        if self._pump_record is not None:
            self._pump_record.close()

    def flight_crash(self, exc: BaseException) -> None:
        """Crash-dump flush: journal the fatal error and force the
        journal to disk before the process dies (the note/flush path is
        what makes a SIGKILL-adjacent crash auditable)."""
        if self.flight is not None:
            self.flight.on_note("crash", repr(exc))
            self.flight.recorder.flush()

    # -- ingress (event-loop side): everything protocol-touching enqueues ----

    def submit_tx(self, tx: bytes) -> int:
        """Local admission (same path as a client TX frame)."""
        t_ingress = time.time()
        status = self.mempool.add(tx, client_id="_local")
        if status == Mempool.ACCEPTED:
            self.pump.enqueue("input", self.make_tx_input(tx),
                              t_ingress, "_local")
        return status

    def _on_peer_message(self, peer_id: NodeId, payload: bytes) -> None:
        self.pump.enqueue("msg", peer_id, payload)

    def _on_peer_batch(self, peer_id: NodeId, items: List[Any]) -> None:
        """Batch-handle fast path (event loop side): one transport chunk
        — every MSG payload and MSG_BATCH sub-message it carried — is
        ONE pump enqueue, so the pump sees one event per chunk instead
        of one per message.  ``items`` are raw payload bytes, or
        ``(payload, decoded_msg_or_None)`` pairs when ingress worker
        threads pre-decode off the loop."""
        self.pump.enqueue("msgs", peer_id, items)

    def _on_guard_event(self, kind: str, peer_id: NodeId,
                        detail: str) -> None:
        """Transport ingress-guard escalations (event loop side): queue
        them through the pump so the journal append — which the pump's
        worker thread owns — stays single-threaded."""
        self.pump.enqueue("guard", kind, peer_id, detail)

    def _on_mempool_shed(self, tx: bytes) -> None:
        self.pump.enqueue("shed", tx)

    def _on_senderq_evict(self, peer_id: NodeId, n: int) -> None:
        """SenderQueue backlog eviction (pump thread): count and
        journal, attributing the overflow to the backlogged peer."""
        self._c_sq_evict.labels(peer=repr(peer_id)).inc(n)
        if self.flight is not None:
            self.flight.on_note(
                "guard", f"kind=senderq_evict peer={peer_id!r} n={n}")

    def _on_peer_hello(self, peer_id: NodeId, hello, direction: str) -> None:
        # ordering with the peer's subsequent messages is preserved by the
        # FIFO inbox (the hello is enqueued before any MSG frame that
        # follows it on the socket)
        self.pump.enqueue("hello", peer_id, hello)

    # -- pump worker (single thread; the only place protocol state mutates) --

    def pump_process(self, events, depth: int) -> _PumpOutcome:
        """One pump iteration: run ``events`` through the protocol, drain
        the cross-epoch deferred crypto, top up the epoch pipeline, prune
        the replay log once.  Runs on the pump's worker thread."""
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)
        out = _PumpOutcome()
        self._out = out
        t_cpu = time.thread_time()
        timing = self._pump_timing
        pc = time.perf_counter
        segs: Dict[str, float] = {}
        t_iter = pc()
        # queue_wait: the iteration's max inbox wait — how long the
        # oldest event of this batch sat parked before the pump got to
        # it (events are (kind, args, t_enq) 3-tuples since the
        # scheduler started stamping them; bare 2-tuples from direct
        # pump_process callers still work)
        max_wait = 0.0
        for ev in events:
            if len(ev) > 2 and t_iter - ev[2] > max_wait:
                max_wait = t_iter - ev[2]
        try:
            if timing is not None:
                self._pump_process_timed(events, depth, timing, segs)
            else:
                for ev in events:
                    kind, args = ev[0], ev[1]
                    t0 = pc()
                    if kind == "msg":
                        self._process_peer_message(*args)
                    elif kind == "msgs":
                        self._process_peer_batch(*args)
                    elif kind == "input":
                        self._process_input(*args)
                    elif kind == "hello":
                        self._process_peer_hello(*args)
                    elif kind == "startup":
                        self._absorb(self.sq.startup_step())
                    elif kind == "guard":
                        self._process_guard_event(*args)
                    elif kind == "shed":
                        self._process_shed(args[0])
                    elif kind == "vid_tick":
                        self._absorb(self._retrieve.tick(time.time()))
                    else:  # pragma: no cover - enqueue() callers are local
                        raise ValueError(f"unknown pump event {kind!r}")
                    # batch-handle events ("msgs") are the same dispatch
                    # work as "msg" — fold them into one segment so the
                    # hot path stays visible to the perf plane
                    sk = "msg" if kind == "msgs" else kind
                    segs[sk] = segs.get(sk, 0.0) + (pc() - t0)
                t0 = pc()
                self._drain_deferred()
                if depth > 1:
                    self._absorb(self.sq.handle_input(PipelineInput(depth)))
                    self._drain_deferred()
                segs["deferred"] = segs.get("deferred", 0.0) + (pc() - t0)
            self._prune_replay()
        finally:
            out.cpu_s = time.thread_time() - t_cpu
            self._out = None
        children = self._pump_seg
        for k, v in segs.items():
            child = children.get(k)
            if child is not None:
                child.observe(v)
        if events:
            children["queue_wait"].observe(max_wait)
        return out

    def _pump_process_timed(self, events, depth: int, timing,
                            segs: Dict[str, float]) -> None:
        """``HBBFT_PUMP_TIMING`` variant of the iteration body: same
        semantics, with per-segment thread-time accumulators (decode /
        protocol / spans / dispatch split inside _process_peer_message is
        approximated by timing that call whole).  ``segs`` receives the
        wall-clock per-kind split so the always-on
        ``hbbft_pump_segment_seconds`` histogram stays populated in this
        mode too."""
        rec = self._pump_record
        if rec is not None:
            for ev in events:
                kind, args = ev[0], ev[1]
                if kind == "msg":
                    rec.write('["msg",%d,"%s"]\n'
                              % (args[0], args[1].hex()))
                elif kind == "msgs":
                    # journal a batch as its per-message lines so replay
                    # profiling stays format-compatible
                    for it in args[1]:
                        p = it[0] if type(it) is tuple else it
                        rec.write('["msg",%d,"%s"]\n'
                                  % (args[0], p.hex()))
                elif kind == "input":
                    tx = getattr(args[0], "tx", None)
                    if tx is not None:
                        rec.write('["input","%s"]\n' % tx.hex())
        tt = time.thread_time
        pc = time.perf_counter
        for ev in events:
            kind, args = ev[0], ev[1]
            t0 = tt()
            w0 = pc()
            if kind == "msg":
                self._process_peer_message(*args)
            elif kind == "msgs":
                self._process_peer_batch(*args)
            elif kind == "input":
                self._process_input(*args)
            elif kind == "hello":
                self._process_peer_hello(*args)
            elif kind == "startup":
                self._absorb(self.sq.startup_step())
            elif kind == "guard":
                self._process_guard_event(*args)
            elif kind == "shed":
                self._process_shed(args[0])
            elif kind == "vid_tick":
                self._absorb(self._retrieve.tick(time.time()))
            else:  # pragma: no cover - enqueue() callers are local
                raise ValueError(f"unknown pump event {kind!r}")
            timing[kind] = timing.get(kind, 0.0) + (tt() - t0)
            timing["n_" + kind] = timing.get("n_" + kind, 0.0) + 1
            sk = "msg" if kind == "msgs" else kind
            segs[sk] = segs.get(sk, 0.0) + (pc() - w0)
        t0 = tt()
        w0 = pc()
        self._drain_deferred()
        if depth > 1:
            self._absorb(self.sq.handle_input(PipelineInput(depth)))
            self._drain_deferred()
        timing["deferred"] = timing.get("deferred", 0.0) + (tt() - t0)
        segs["deferred"] = segs.get("deferred", 0.0) + (pc() - w0)

    def _drain_deferred(self) -> None:
        """Resolve every parked threshold-decrypt verification — ONE
        merged MSM/pairing call per round via crypto.batch — looping while
        resolutions cascade into new threshold crossings."""
        guard = 0
        while self.sq.has_deferred():
            self._absorb(self.sq.resolve_deferred())
            guard += 1
            if guard > 64:  # pragma: no cover - each round consumes jobs
                logger.error("deferred-crypto drain did not settle")
                break

    def pump_flush(self, out: _PumpOutcome) -> None:
        """Apply one iteration's side effects on the event loop: coalesced
        MSG/MSG_BATCH frames per peer, then client commit pushes."""
        timing = self._pump_timing
        w0 = time.perf_counter()
        if timing is not None:
            t0 = time.thread_time()
            self._pump_flush_body(out)
            timing["flush"] = (
                timing.get("flush", 0.0) + (time.thread_time() - t0))
        else:
            self._pump_flush_body(out)
        self._pump_seg["flush"].observe(time.perf_counter() - w0)

    def _pump_flush_body(self, out: _PumpOutcome) -> None:
        for dest, payloads in out.frames.items():
            try:
                self.transport.send_payloads(dest, payloads)
            except KeyError:
                # a target that is not a transport peer (e.g. an observer
                # known only to the SenderQueue) has nowhere to go yet
                self.send_failures += 1
                logger.warning("no transport peer for %r: dropped %d "
                               "payloads", dest, len(payloads))
        if out.frames_delayed:
            loop = asyncio.get_running_loop()
            for dest, payloads in out.frames_delayed.items():
                loop.call_later(self.aba_out_delay_s, self._send_shaped,
                                dest, payloads)
        for era, epoch, digests in out.commits:
            self._notify_commit(era, epoch, digests)
        for digest in out.sheds:
            # ACK_SHED push: every client sees it; only the one holding
            # the digest's commit waiters reacts (the others ignore it)
            for conn in list(self._clients):
                conn.send(framing.TX_ACK,
                          bytes([framing.ACK_SHED]) + digest)
                if conn.closed:
                    self._clients.discard(conn)

    def _send_shaped(self, dest: NodeId, payloads: List[bytes]) -> None:
        try:
            self.transport.send_payloads(dest, payloads)
        except KeyError:
            self.send_failures += 1
            logger.warning("no transport peer for %r: dropped %d shaped "
                           "payloads", dest, len(payloads))

    def _process_input(self, inp: Any, t_ingress: Optional[float] = None,
                       client: str = "") -> None:
        """A mempool-admitted input (pump thread): journal its per-tx
        ``ingress`` (event-loop admission time, captured at the mempool
        add) and ``queued`` (now: the pump dequeued it) trace stages —
        the journal append itself stays on the pump thread, the one
        place appends are allowed — then feed the protocol."""
        if self.flight is not None:
            tx = getattr(inp, "tx", None)
            if isinstance(tx, (bytes, bytearray)):
                tid = trace_id(bytes(tx))
                era, epoch = self.current_key()
                self.flight.recorder.record_trace(
                    "ingress", era, epoch, tid, detail=client,
                    t=t_ingress)
                self.flight.recorder.record_trace(
                    "queued", era, epoch, tid, t=time.time())
        self._absorb(self.sq.handle_input(inp))

    def _process_guard_event(self, kind: str, peer_id: NodeId,
                             detail: str) -> None:
        """Journal a transport guard escalation (pump thread — the one
        place journal appends are allowed)."""
        if self.flight is not None:
            self.flight.on_note("guard",
                                f"kind={kind} peer={peer_id!r} {detail}")

    def _process_shed(self, tx: bytes) -> None:
        """A mempool shed (pump thread): drop the tx from the protocol
        queue so the shed frees consensus-side memory too, not just
        mempool bookkeeping — and queue the client push notification
        (written by pump_flush on the event loop).  The notification is
        DEFINITIVE: it is suppressed when the tx was no longer in the
        queue or is riding a not-yet-committed proposal (a proposal
        cannot be recalled, so such a tx may still commit — the client
        must not be told it never will)."""
        tx = bytes(tx)
        queue = getattr(self.sq.algo, "queue", None)
        if queue is None:
            return
        removed = queue.remove_multiple({tx})
        in_flight = getattr(self.sq.algo, "in_flight_txs", None)
        riding = in_flight is not None and tx in in_flight()
        if removed and not riding and self._out is not None:
            self._out.sheds.append(tx_digest(tx))

    def _process_peer_message(self, peer_id: NodeId, payload: bytes) -> None:
        self.transport.ingress.frame_done(peer_id)
        timing = self._pump_timing
        t0 = time.thread_time() if timing is not None else 0.0
        # Decode memo: wire messages are frozen/immutable, and much of an
        # epoch's traffic is byte-identical payloads from different peers
        # (Ready/BVal/Aux/Conf/Term broadcasts carry no sender field), so
        # sharing the decoded object is safe and skips the full TLV walk
        # for ~half the messages.  Bounded: cleared wholesale at the cap,
        # so a Byzantine payload flood costs reruns, not memory.
        cache = self._decode_cache
        msg = cache.get(payload)
        if msg is not None and timing is not None:
            timing["n_dec_hit"] = timing.get("n_dec_hit", 0) + 1
        if msg is None:
            try:
                msg = wire.decode_message(payload)
            except ValueError as exc:
                self.decode_failures += 1
                self.transport.ingress.decode_strike(peer_id)
                logger.warning("undecodable message from %r: %s",
                               peer_id, exc)
                return
            if len(cache) >= 4096:
                cache.clear()
            cache[payload] = msg
        if not isinstance(msg, (AlgoMessage, EpochStarted)):
            # runtime-level VID retrieval traffic rides the same sockets
            # but never enters the SenderQueue: route it to the retrieve
            # service (whose Steps absorb exactly like protocol steps)
            if self._retrieve is not None and isinstance(
                    msg, (VidRetrieve, VidShard)):
                if self.flight is not None:
                    self.flight.on_message(peer_id, msg,
                                           payload=bytes(payload))
                self._process_vid_direct(peer_id, msg)
                return
            self.decode_failures += 1
            self.transport.ingress.decode_strike(peer_id)
            logger.warning("non-sender-queue message %s from %r",
                           type(msg).__name__, peer_id)
            return
        if timing is not None:
            t1 = time.thread_time()
            timing["m_decode"] = timing.get("m_decode", 0.0) + (t1 - t0)
        self.spans.on_message(peer_id, msg)
        if self.flight is not None:
            self.flight.on_message(peer_id, msg, payload=bytes(payload))
        if timing is not None:
            t2 = time.thread_time()
            timing["m_spans"] = timing.get("m_spans", 0.0) + (t2 - t1)
        try:
            step = self.sq.handle_message(peer_id, msg)
        except TypeError as exc:
            # decodable but protocol-unexpected (e.g. AlgoMessage wrapping
            # a bare ReadyMsg): Byzantine input at the network boundary —
            # count it, keep the connection and the loop alive (the
            # guard's strike ladder disconnects a sustained stream)
            self.decode_failures += 1
            self.transport.ingress.decode_strike(peer_id)
            logger.warning("protocol-rejected message from %r: %s",
                           peer_id, exc)
            return
        if timing is not None:
            t3 = time.thread_time()
            timing["m_handle"] = timing.get("m_handle", 0.0) + (t3 - t2)
            self._absorb(step)
            timing["m_absorb"] = (
                timing.get("m_absorb", 0.0) + (time.thread_time() - t3))
            return
        self._absorb(step)

    def _process_peer_batch(self, peer_id: NodeId,
                            items: List[Any]) -> None:
        """One transport chunk's payloads as ONE pump unit: a single
        in-flight retire, one :meth:`SenderQueue.handle_message_batch`
        call merging the per-message Steps, one ``_absorb`` (one
        spans/flight step pass, with ``_dispatch``'s broadcast-encode
        cache shared across the whole batch).  Per-item error handling
        matches :meth:`_process_peer_message` exactly — an undecodable,
        non-sender-queue, or protocol-rejected item strikes THIS peer
        and is skipped, never voiding the rest of the batch — and the
        handle order is the socket order, so ledgers are byte-identical
        with the per-message path."""
        self.transport.ingress.frame_done(peer_id, len(items))
        timing = self._pump_timing
        t0 = time.thread_time() if timing is not None else 0.0
        cache = self._decode_cache
        strike = self.transport.ingress.decode_strike
        msgs: List[Any] = []
        payloads: Dict[int, bytes] = {}
        for item in items:
            if type(item) is tuple:
                # ingress-worker pre-decoded (payload, msg|None) pair
                payload, msg = item
            else:
                payload, msg = item, None
            if msg is None:
                msg = cache.get(payload)
                if msg is None:
                    try:
                        msg = wire.decode_message(payload)
                    except ValueError as exc:
                        self.decode_failures += 1
                        strike(peer_id)
                        logger.warning("undecodable message from %r: %s",
                                       peer_id, exc)
                        continue
                    if len(cache) >= 4096:
                        cache.clear()
                    cache[payload] = msg
                elif timing is not None:
                    timing["n_dec_hit"] = timing.get("n_dec_hit", 0) + 1
            if not isinstance(msg, (AlgoMessage, EpochStarted)):
                if self._retrieve is not None and isinstance(
                        msg, (VidRetrieve, VidShard)):
                    # handled inline: retrieval traffic is ordering-
                    # independent of the consensus messages around it
                    if self.flight is not None:
                        self.flight.on_message(peer_id, msg,
                                               payload=payload)
                    self._process_vid_direct(peer_id, msg)
                    continue
                self.decode_failures += 1
                strike(peer_id)
                logger.warning("non-sender-queue message %s from %r",
                               type(msg).__name__, peer_id)
                continue
            # keep the wire payload beside the message: the flight
            # journal records it verbatim, skipping a re-encode (the
            # decode cache may hand back one msg object for identical
            # payloads — same bytes either way)
            payloads[id(msg)] = payload
            msgs.append(msg)
        if timing is not None:
            t1 = time.thread_time()
            timing["m_decode"] = timing.get("m_decode", 0.0) + (t1 - t0)
        if not msgs:
            return
        spans = self.spans
        flight = self.flight

        def pre(msg):
            spans.on_message(peer_id, msg)
            if flight is not None:
                flight.on_message(peer_id, msg,
                                  payload=payloads.get(id(msg)))

        def on_error(msg, exc):
            # decodable but protocol-unexpected: Byzantine input at the
            # network boundary — count it, keep connection + batch alive
            self.decode_failures += 1
            strike(peer_id)
            logger.warning("protocol-rejected message from %r: %s",
                           peer_id, exc)

        step = self.sq.handle_message_batch(peer_id, msgs, pre=pre,
                                            on_error=on_error)
        if timing is not None:
            t2 = time.thread_time()
            timing["m_handle"] = timing.get("m_handle", 0.0) + (t2 - t1)
            self._absorb(step)
            timing["m_absorb"] = (
                timing.get("m_absorb", 0.0) + (time.thread_time() - t2))
            return
        self._absorb(step)

    def _process_peer_hello(self, peer_id: NodeId, hello) -> None:
        # A hello means a (re)connection: whatever we previously drained
        # into a socket for this peer may have died in TCP buffers, and a
        # below-record key means it restarted outright (possibly from
        # (0, 0)).  At-least-once, uniformly: (re)set its sender-queue
        # record to the announced key and replay the retained log from
        # there — entries below the key are obsolete at the peer, resent
        # duplicates above it are protocol no-ops.  On a clean first
        # connect the log is empty and this degrades to registering the
        # peer and exchanging EpochStarted.
        key = hello.key
        cur = self.sq.peer_epochs.get(peer_id)
        history = [
            (k, m) for k, m, _p in self._replay.get(peer_id, [])
            if k >= key
        ]
        if history or (cur is not None and key < cur):
            logger.info("peer %r reconnected at %r (recorded %r): "
                        "replaying %d retained messages through the "
                        "sender queue", peer_id, key, cur, len(history))
        # retention check: if the oldest retained entry is already beyond
        # the peer's delivery window, nothing we replay is deliverable and
        # the peer can never announce progress — it is wedged, not merely
        # catching up.  Surface that loudly instead of stalling silently
        # (remedy: restart the peer from a snapshot, or raise
        # replay_retain_epochs).
        window = _algo_window(self.sq.algo)
        if history and min(e[0] for e in history) > (key[0],
                                                     key[1] + window):
            self.replay_gaps += 1
            if self.flight is not None:
                self.flight.on_note(
                    "replay_gap",
                    f"peer={peer_id!r} announced={key!r} "
                    f"oldest_retained={min(e[0] for e in history)!r}")
            logger.error(
                "peer %r announced %r but the replay log only reaches "
                "back to %r (> window %d): retention does not cover its "
                "gap; it cannot catch up from here",
                peer_id, key, min(e[0] for e in history), window,
            )
        self._absorb(self.sq.reinit_peer(peer_id, key, history))

    def _absorb(self, step: Step) -> None:
        try:
            for fault in step.fault_log:
                self._c_faults.labels(kind=fault.kind.name).inc()
                name = fault.kind.name
                if name == "FutureEpochFlood":
                    self._c_proto_drops.labels(kind="hb_future").inc()
                elif name == "SubsetMessageFlood":
                    self._c_proto_drops.labels(kind="subset").inc()
            self.spans.on_step(step)
            if self.flight is not None:
                self.flight.on_step(step)
            for out in step.output:
                if isinstance(out, (QhbBatch, DhbBatch, HbBatch,
                                    VidQhbBatch)):
                    self._on_batch(out)
                elif isinstance(out, VidCertReady):
                    # proposer-side audit anchor: every retriever's
                    # vid_retrieved note must corroborate this digest
                    if self.flight is not None:
                        self.flight.on_note(
                            "vid_cert",
                            f"root={out.root.hex()} len={out.total_len} "
                            f"payload_sha3={out.payload_sha3}")
                elif isinstance(out, RetrievedPayload):
                    self._on_retrieved(out)
            self._dispatch(step)
        except Exception as exc:
            # fatal in the consensus path: flush the black box so the
            # journal's last records survive whatever happens next
            self.flight_crash(exc)
            raise

    def _dispatch(self, step: Step) -> None:
        """Accumulate the step's outbound payloads into the current pump
        outcome (coalesced + written once per iteration by pump_flush)."""
        out = self._out
        our = self.our_id()
        peer_ids = self.transport.peer_ids()
        all_ids = peer_ids + [our]
        max_payload = self.transport.max_frame - 1
        # The SenderQueue fans a broadcast into one per-peer AlgoMessage
        # wrapping the SAME inner message object; encoding each copy
        # costs the hot path ~3× the bytes it needs.  Cache by inner-
        # object identity — safe because every message in `step` stays
        # referenced for the duration of this call.
        enc_cache: Dict[int, bytes] = {}
        for tm in step.messages:
            msg = tm.message
            if isinstance(msg, AlgoMessage):
                ckey = id(msg.msg)
                payload = enc_cache.get(ckey)
                if payload is None:
                    payload = enc_cache[ckey] = wire.encode_message(msg)
            else:
                payload = wire.encode_message(msg)
            if len(payload) > max_payload:
                # an oversized frame must not abort the rest of the
                # Step's fan-out (the mempool's max_tx_bytes admission
                # bound makes this unreachable for honest configs)
                self.send_failures += 1
                logger.error("dropping oversized frame (%d bytes > cap)",
                             len(payload))
                continue
            key = (
                message_key(tm.message.msg)
                if isinstance(tm.message, AlgoMessage) else None
            )
            shed: FrozenSet[Any] = frozenset()
            if (self._vid and self.vid_shed_backlog_s > 0
                    and isinstance(msg, AlgoMessage)
                    and type(msg.msg) is VidDisperse):
                shed = self._shed_for_disperse(msg.msg.root, peer_ids)
            frames = out.frames
            if self.aba_out_delay_s > 0 and key is not None:
                from hbbft_tpu_torch.obs.spans import classify

                hit = classify(msg.msg)
                if hit is not None and hit[2].startswith("aba_") and (
                    not self.aba_out_classes
                    or hit[2] in self.aba_out_classes
                ):
                    frames = out.frames_delayed
            for dest in tm.target.resolve(all_ids, our):
                if dest in shed and dest != our:
                    # skip replay registration too: a reconnect replay
                    # pushing the shard would defeat the shed entirely
                    self._vid_sheds += 1
                    if self.flight is not None:
                        self.flight.on_note(
                            "vid_shed",
                            f"root={msg.msg.root.hex()} peer={dest!r}")
                    continue
                frames.setdefault(dest, []).append(payload)
                if key is not None:
                    dedup = (key, payload)
                    seen = self._replay_seen.setdefault(dest, set())
                    if dedup not in seen:
                        seen.add(dedup)
                        self._replay.setdefault(dest, []).append(
                            (key, msg.msg, payload)
                        )
                        self._replay_bytes[dest] = (
                            self._replay_bytes.get(dest, 0) + len(payload)
                        )

    def _prune_replay(self) -> None:
        era, epoch = self.current_key()
        if epoch >= self.replay_retain_epochs:
            floor = (era, epoch - self.replay_retain_epochs)
        else:
            # young era: a naive (era, epoch−retain) floor would discard
            # the ENTIRE previous era the instant a DKG rotation lands,
            # breaking replay for a peer whose outage spans the boundary.
            # Keep the previous era's tail (itself already pruned to its
            # last `retain` epochs while that era was current) until this
            # era is `retain` epochs old.
            floor = (era - 1, 0) if era > 0 else (0, 0)
        cap = self.replay_retain_bytes
        for dest, entries in self._replay.items():
            i = 0
            if entries and entries[0][0] < floor:
                # entries are appended in send order (keys non-decreasing
                # modulo reinit merges), so pruning is a front chop —
                # incremental, not a full list+set rebuild per epoch
                n = len(entries)
                while i < n and entries[i][0] < floor:
                    i += 1
            if cap > 0 and self._replay_bytes.get(dest, 0) > cap:
                # byte ceiling (bounded storage): keep chopping the
                # oldest entries past the epoch floor until the peer's
                # log fits — measured AFTER crediting what the epoch
                # floor is already removing, so the cap never truncates
                # more than it must.  Chopped entries are counted — they
                # were still inside epoch retention, so a peer that
                # needed them must recover via snapshot state-sync.
                floor_bytes = sum(len(p) for _k, _m, p in entries[:i])
                over = self._replay_bytes[dest] - floor_bytes - cap
                j = i
                n = len(entries)
                while j < n and over > 0:
                    over -= len(entries[j][2])
                    j += 1
                if j > i:
                    self._c_replay_trunc.inc(j - i)
                    i = j
            if i:
                seen = self._replay_seen.get(dest)
                if seen is not None:
                    for k, _m, p in entries[:i]:
                        seen.discard((k, p))
                self._replay_bytes[dest] = self._replay_bytes.get(
                    dest, 0) - sum(len(p) for _k, _m, p in entries[:i])
                del entries[:i]

    # -- batches & clients ---------------------------------------------------

    def _on_batch(self, batch: Any) -> None:
        self.batches.append(batch)
        self.ledger_digest = hashlib.sha3_256(
            self.ledger_digest + wire.batch_bytes(batch)
        ).digest()
        self._digest_chain.append(self.ledger_digest.hex())
        if len(self._digest_chain) > self.digest_chain_retain:
            drop = len(self._digest_chain) - self.digest_chain_retain
            del self._digest_chain[:drop]
            self._digest_chain_offset += drop
        change = getattr(batch, "change", None)
        if change is not None and change.state == "complete":
            # a DKG rotation just landed: this instant — the new era's
            # boundary, before any of its epochs complete — is the only
            # moment join_plan() is valid.  Package it with the committed
            # DKG transcript and the chain position as the served join
            # snapshot.
            dhb = self._inner_dhb()
            if dhb is not None:
                try:
                    self.sync_store.publish(capture_join_snapshot(
                        dhb, self.ledger_digest, self.chain_len))
                except ValueError as exc:
                    # a replayed future-era message already completed an
                    # epoch of the new era inside this same step — the
                    # boundary passed before we saw it.  Counted: joiners
                    # must wait for the next rotation.
                    self.sync_store._c_capture_misses.inc()
                    logger.warning("join snapshot not captured at era "
                                   "%d boundary: %s", dhb.era, exc)
        if (self.flight_retain_batches > 0 and self.flight is not None
                and self.chain_len % 16 == 0):
            # bounded storage: drop whole journal segments that lie
            # entirely below the digest-chain checkpoint horizon (the
            # chain head + /status cover the truncated history)
            self.flight.recorder.truncate_checkpoint(
                self.chain_len - self.flight_retain_batches)
        if isinstance(batch, QhbBatch):
            txs = batch.all_txs()
            self._c_committed.inc(len(txs))
            digests = self.mempool.mark_committed(txs)
            # client sockets are event-loop objects: the notification is
            # queued on the outcome and written by pump_flush
            self._out.commits.append((batch.era, batch.epoch, digests))
        elif isinstance(batch, VidQhbBatch):
            self._on_vid_batch(batch)
        if self.on_batch is not None:
            self.on_batch(batch)

    # -- VID resolution (pump thread) ----------------------------------------

    def _process_vid_direct(self, peer_id: NodeId, msg: Any) -> None:
        """Route runtime-level retrieval traffic (pump thread)."""
        now = time.time()
        if isinstance(msg, VidRetrieve):
            self._absorb(self._retrieve.handle_retrieve(peer_id, msg, now))
        else:
            self._absorb(self._retrieve.handle_shard(peer_id, msg, now))

    def _on_vid_batch(self, batch: VidQhbBatch) -> None:
        """An epoch ORDERED in VID mode: commit what resolves locally
        (plain contributions, our own dispersals) right now, open a
        retrieval for every foreign commitment.  ``commit`` is the
        ordering instant; each contribution's ``commit_retrieved``
        lands when its payload does — identical timestamps for the
        locally-resolved part, so the two stages always bracket the
        retrieval gap exactly."""
        now = time.time()
        vqhb = self.sq.algo
        ni = vqhb.dhb.netinfo
        txs: List[bytes] = []
        for _proposer, plain in batch.plain_txs():
            txs.extend(plain)
        for proposer, cert in batch.commitments():
            local = vqhb.disperser.local_payload(cert.root)
            if local is not None:
                txs.extend(_de_txs(local))
                if self.flight is not None:
                    self.flight.on_note(
                        "vid_retrieved",
                        f"root={cert.root.hex()} "
                        f"payload_sha3={payload_digest(local)} "
                        f"shards_bad=0 rounds=0")
                continue
            # _vid_pending first: start() can complete synchronously
            # (our own stored shard suffices when k == 1) and the
            # resulting RetrievedPayload resolves through _on_retrieved
            self._vid_pending[cert.root] = (batch.era, batch.epoch)
            # holders in shard-index order: node i stores shard i, so the
            # retrieve service can target exactly the missing indices
            holders = tuple(sorted(ni.all_ids(), key=ni.node_index))
            self._absorb(self._retrieve.start(
                cert.root, cert.total_len, ni.num_nodes(),
                ni.num_faulty(), proposer, now, now, holders=holders))
        if txs:
            self._c_committed.inc(len(txs))
            digests = self.mempool.mark_committed(txs)
            self._out.commits.append((batch.era, batch.epoch, digests))
            self._vid_traces(batch.era, batch.epoch, txs, now, now)

    def _on_retrieved(self, rp: RetrievedPayload) -> None:
        """A retrieval finished (pump thread): surface the audit note,
        and on success commit the transactions against the ordering
        position recorded at batch time."""
        key = self._vid_pending.pop(rp.root, None)
        if key is None:
            return
        era, epoch = key
        now = time.time()
        sha3 = (payload_digest(rp.payload)
                if rp.payload is not None else "none")
        if self.flight is not None:
            self.flight.on_note(
                "vid_retrieved",
                f"root={rp.root.hex()} payload_sha3={sha3} "
                f"shards_bad={rp.shards_bad} rounds={rp.rounds}")
        if rp.payload is None:
            # mismatch / exhaustion: the service already logged the
            # fault evidence; the contribution resolves to nothing on
            # every correct node identically
            return
        try:
            txs = list(_de_txs(rp.payload))
        except ValueError:
            # a valid codeword of a non-contribution payload: the
            # proposer certified garbage — same fault class as a plain
            # contribution that fails to deserialize
            self._absorb(Step.from_fault(
                rp.proposer, FaultKind.BatchDeserializationFailed))
            return
        self.sq.algo.on_retrieved(txs)
        self._c_committed.inc(len(txs))
        digests = self.mempool.mark_committed(txs)
        self._out.commits.append((era, epoch, digests))
        self._vid_traces(era, epoch, txs, rp.t_ordered, now)

    def _vid_traces(self, era: int, epoch: int, txs: List[bytes],
                    t_ordered: float, t_resolved: float) -> None:
        """Journal the commit / commit_retrieved stage pair: ``commit``
        carries the ordering timestamp, ``commit_retrieved`` the moment
        the payload became readable, so per-tx waterfalls report both
        latencies and their difference is exactly the retrieval gap."""
        if self.flight is None or not txs:
            return
        tids = b"".join(trace_id(bytes(tx)) for tx in txs)
        self.flight.recorder.record_trace("commit", era, epoch, tids,
                                          t=t_ordered)
        self.flight.recorder.record_trace("commit_retrieved", era, epoch,
                                          tids, t=t_resolved)

    def _notify_commit(self, era: int, epoch: int,
                       digests: List[bytes]) -> None:
        if not self._clients or not digests:
            return
        payload = struct.pack(">QQI", era, epoch, len(digests)) + b"".join(
            digests
        )
        for conn in list(self._clients):
            conn.send(framing.TX_COMMIT, payload)
            if conn.closed:
                self._clients.discard(conn)

    def _on_client_frame(self, conn: ClientConn, kind: int,
                         payload: bytes) -> None:
        if kind == framing.SYNC:
            # snapshot state-sync (joiner bootstrap): request → reply on
            # this connection, WITHOUT registering it for commit pushes —
            # a transferring joiner wants chunks, not TX_COMMIT noise
            try:
                msg = wire.decode_message(payload)
            except ValueError as exc:
                from hbbft_tpu_torch.net.statesync import SyncNack

                self.sync_store._c_nacks.inc()
                logger.warning("undecodable sync request: %s", exc)
                conn.send(framing.SYNC,
                          wire.encode_message(SyncNack("bad request")))
                return
            conn.send(framing.SYNC,
                      wire.encode_message(self.sync_store.handle(msg)))
            return
        self._clients.add(conn)
        if kind == framing.TX:
            # admission (bounded, dedup'd, FAIR per client under FULL
            # pressure) and the ack stay on the event loop — backpressure
            # must not wait behind a pump iteration; only the accepted
            # input crosses into the pump
            t_ingress = time.time()
            status = self.mempool.add(payload,
                                      client_id=str(conn.client_id))
            conn.send(framing.TX_ACK, bytes([status]) + tx_digest(payload))
            if status == Mempool.ACCEPTED:
                self.pump.enqueue("input", self.make_tx_input(payload),
                                  t_ingress, str(conn.client_id))
        elif kind == framing.STATUS_REQ:
            # optional u32 payload: digest-chain tail length (0 = just the
            # head/length — the cheap poll loops use this; the full
            # 256-entry default costs ~16 KB of JSON per request)
            tail = 256
            if len(payload) == 4:
                tail = struct.unpack(">I", payload)[0]
            conn.send(framing.STATUS,
                      json.dumps(self.status_doc(chain_tail=tail)).encode())
        else:
            logger.warning("unknown client frame kind %d", kind)

    def _on_client_gone(self, conn: ClientConn) -> None:
        self._clients.discard(conn)

    def status_doc(self, chain_tail: int = 256) -> dict:
        era, epoch = self.current_key()
        local = max(0, len(self._digest_chain) - chain_tail)
        return {
            "node": repr(self.our_id()),
            "era": era,
            "epoch": epoch,
            "batches": len(self.batches),
            "ledger": self.ledger_digest.hex(),
            # chain head + total length: what the forensic auditor
            # cross-checks against a live node without the full journal
            "chain_head": self.ledger_digest.hex(),
            "chain_len": self.chain_len,
            "digest_chain": self._digest_chain[local:],
            "digest_chain_offset": self._digest_chain_offset + local,
            "flight": (self.flight.recorder.stats_doc()
                       if self.flight is not None else None),
            "committed_txs": self.committed_txs,
            "mempool": len(self.mempool),
            "decode_failures": self.decode_failures,
            "send_failures": self.send_failures,
            "replay_gaps": self.replay_gaps,
            "replay_truncations": int(self._c_replay_trunc.total()),
            "replay_log_bytes": sum(self._replay_bytes.values()),
            "sync_snapshot": (
                {
                    "era": self.sync_store.manifest.era,
                    "chain_len": self.sync_store.manifest.chain_len,
                    "image_len": self.sync_store.manifest.image_len,
                }
                if self.sync_store.manifest is not None else None
            ),
            "guard": {
                "ingress": self.transport.ingress.as_dict(),
                "senderq_evictions": int(self._c_sq_evict.total()),
                "senderq_buffered": {
                    repr(p): len(e)
                    for p, e in list(self.sq.buffered.items())
                },
                "protocol_drops": {
                    "hb_future": int(self._c_proto_drops.value(
                        kind="hb_future")),
                    "subset": int(self._c_proto_drops.value(
                        kind="subset")),
                },
                "mempool_sheds": dict(self.mempool.sheds),
            },
            "degraded": (self.degrade.as_dict()
                         if self.degrade is not None else None),
            # the perf plane's compact view: the single headroom scalar
            # plus per-layer utilization (full doc at /perf)
            "perf": self.perf.summary(),
            "headroom": self.perf.headroom(),
            "vid": (
                {
                    "pending_retrievals": self._retrieve.pending_count(),
                    "store_bytes": self.sq.algo.store.bytes,
                    "store_roots": len(self.sq.algo.store),
                    **self._vid_stats(),
                }
                if self._vid else None
            ),
            "faults_observed": self.faults_observed,
            "peers_connected": sum(
                1 for p in self.transport.peer_ids()
                if self.transport.connected(p)
            ),
            "epochs_traced": self.spans.epochs_finalized,
            "pipeline_depth": self.pipeline_depth,
            "epochs_in_flight": (
                len(self._inner_hb().epochs)
                if self._inner_hb() is not None else 0
            ),
            "obs_addr": list(self.obs_addr) if self.obs_addr else None,
            "stats": self.transport.stats.as_dict(),
        }

    def health_doc(self) -> dict:
        """The ``/health`` document: machine-readable status + headroom.

        Shaped for the adaptive-control ladder (``net/degrade.py``): every
        lever the controller could pull is reported as used/cap/frac so
        "how much room is left" needs no endpoint-specific knowledge.
        Read-only snapshot — safe from the obs HTTP thread; the
        journaled transition record is the pump heartbeat's job
        (:meth:`_health_tick`)."""
        era, epoch = self.current_key()
        issues = self._health_issues()

        def lever(used: int, cap: int) -> dict:
            return {"used": used, "cap": cap,
                    "frac": round(used / cap, 4) if cap else 0.0}

        mp = self.mempool
        hb = self._inner_hb()
        return {
            "node": repr(self.our_id()),
            "status": "degraded" if issues else "ok",
            "issues": issues,
            "transitions": self._health_transitions,
            "era": era,
            "epoch": epoch,
            "chain_len": self.chain_len,
            "headroom": {
                "mempool": lever(len(mp), mp.capacity),
                "mempool_bytes": lever(mp.pending_bytes,
                                       mp.max_pending_bytes),
                "pipeline": lever(
                    len(hb.epochs) if hb is not None else 0,
                    self.pipeline_depth),
                # the pump drains max_batch events per iteration: a
                # backlog persistently above it means the node is
                # processing-bound, not waiting for traffic
                "pump_backlog": lever(self.pump.pending(),
                                      self.pump.max_batch),
                "vid_pending": (self._retrieve.pending_count()
                                if self._retrieve is not None else 0),
            },
            # the perf plane's measured slack scalar (None before the
            # first complete sampling window) + per-layer utilization —
            # what the controller's raise arm actually consumes
            "perf_headroom": self.perf.headroom(),
            "util": self.perf.utilization(),
            "degrade": (self.degrade.as_dict()
                        if self.degrade is not None else None),
            "guard": {
                "senderq_evictions": int(self._c_sq_evict.total()),
                "mempool_sheds": sum(self.mempool.sheds.values()),
            },
            "peers_connected": sum(
                1 for p in self.transport.peer_ids()
                if self.transport.connected(p)
            ),
            "send_failures": self.send_failures,
        }
